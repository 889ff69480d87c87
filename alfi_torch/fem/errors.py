"""Error norms against manufactured solutions (the JAX package's
``fem/errors.py``; the reference's MMS harness, examples/mms.py:57-67):
|u - u_h|_0, |grad(u - u_h)|_0, |p - p_h|_0 (both pressures mean-
corrected) and |div u_h|_0, by a quadrature of the form's degree plus
``degree_bump``.  The exact fields are torch functions of one point (the
MMS problems' ``u_exact``, ``p_exact``); their gradients come from
``torch.func.jacfwd``."""

from __future__ import annotations

import torch

from .nsforms import Tabulation


class ErrorComputer:
    def __init__(self, form, degree_bump=3):
        self.form = form
        deg = form.quad_degree + degree_bump
        self.tab_v = Tabulation(form.V.element, form.dim, deg,
                                device=form.device)
        self.tab_q = Tabulation(form.Q.element, form.dim, deg,
                                device=form.device)
        g = form.geom
        self.xq = g.quad_points_physical(self.tab_v.ref_pts)
        self.wdet = self.tab_v.w[None, :] * g.detj[:, None]
        self.jinv = g.jinv
        self.area = g.vol.sum()

    def _at_points(self, fn):
        """fn (one point -> value) at every quadrature point, (nc, nq,
        ...)."""
        nc, nq, d = self.xq.shape
        vals = torch.func.vmap(fn)(self.xq.reshape(-1, d))
        return vals.reshape(nc, nq, *vals.shape[1:])

    def velocity_errors(self, u, u_exact):
        """(L2 error, H1-seminorm error) against the exact field
        ``u_exact`` (a torch function of one point)."""
        tv = self.tab_v
        u_loc = u[self.form.cd_v]
        uh = torch.einsum("ql,cld->cqd", tv.phi, u_loc)
        guh = torch.einsum("qle,cej,cli->cqij", tv.gphi, self.jinv, u_loc)
        de = uh - self._at_points(u_exact)
        dg = guh - self._at_points(torch.func.jacfwd(u_exact))
        l2 = torch.sqrt(torch.einsum("cq,cqd,cqd->", self.wdet, de, de))
        h1 = torch.sqrt(torch.einsum("cq,cqij,cqij->", self.wdet, dg, dg))
        return l2, h1

    def pressure_error(self, p, p_exact):
        """L2 error with both fields mean-corrected (the exact
        Shih-Tan-Hwang pressure is defined up to a constant here)."""
        ph = torch.einsum("ql,cl->cq", self.tab_q.phi, p[self.form.cd_q])
        pe = self._at_points(p_exact)
        ph = ph - torch.einsum("cq,cq->", self.wdet, ph) / self.area
        pe = pe - torch.einsum("cq,cq->", self.wdet, pe) / self.area
        d = ph - pe
        return torch.sqrt(torch.einsum("cq,cq,cq->", self.wdet, d, d))

    def divergence_norm(self, u):
        gu = torch.einsum("qle,cej,cli->cqij", self.tab_v.gphi, self.jinv,
                          u[self.form.cd_v])
        divu = torch.einsum("cqii->cq", gu)
        return torch.sqrt(torch.einsum("cq,cq,cq->", self.wdet, divu, divu))
