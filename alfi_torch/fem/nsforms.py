"""Navier-Stokes residual and element tensors (device, batched over cells).

Hand-derived element kernels for the reference's fixed form set:

* ``pkp0`` residual (alfi/solver.py:562-572):
      nu (2 sym grad u, grad v) + gamma (cell_avg(div u), div v)
      + advect ((grad u) u, v) - (p, div v) - (div u, q)
* ``sv`` residual (alfi/solver.py:613-623): the same with the exact
  gamma (div u, div v) term,

plus the optional forcing ``rhs`` (the manufactured solutions,
``problems/mms.py``) and ``stabilisation`` hook (SUPG/GLS or Burman,
alfi_torch/stabilisation.py).

Every per-cell quantity is one einsum over a leading cell axis (the JAX
package vmaps a single-cell kernel instead), and assembly is an
out-of-place scatter-add (:class:`~.scatter.ScatterAdd`, whose sums
repeat on the card) so that ``torch.func.jvp`` of the residual is the
exact matrix-free Newton matvec.  The element tensors (viscous K,
grad-div G, advection N) are closed forms of that residual's Jacobian.
"""

from __future__ import annotations

import copy

import torch

from ..config import real_dtype
from .geometry import CellGeometry
from .quadrature import simplex_quadrature
from .scatter import ScatterAdd


class Tabulation:
    """Reference-element tabulation at a quadrature rule (constants)."""

    def __init__(self, element, dim, degree, *, device):
        pts, wts = simplex_quadrature(dim, degree)

        def dev(a):
            return torch.as_tensor(a, dtype=real_dtype, device=device)

        self.ref_pts = pts
        self.w = dev(wts)
        self.phi = dev(element.tabulate(pts))  # (nq, nloc)
        self.gphi = dev(element.tabulate_grad(pts))  # (nq, nloc, d)
        self.nq = len(wts)
        self.nloc = element.nloc


class NSForm:
    """Residual of the AL Navier-Stokes system for one (V, Q) pair.

    graddiv_mode: 'cell_avg' (Pk-P0) or 'exact' (Scott-Vogelius).
    rhs: optional forcing, rhs(x (n, d), params) -> (f_v (n, d), f_q (n,)).
    """

    def __init__(self, V, Q, graddiv_mode, quad_degree=None, rhs=None, *,
                 device):
        if graddiv_mode not in ("cell_avg", "exact"):
            raise ValueError("graddiv_mode %r" % graddiv_mode)
        self.V = V
        self.Q = Q
        mesh = V.mesh
        self.mesh = mesh
        d = mesh.dim
        self.dim = d
        self.device = torch.device(device)
        self.graddiv_mode = graddiv_mode
        ku = V.element.degree
        kq = Q.element.degree
        if quad_degree is None:
            # advection (grad u) u . v is the highest-degree term
            quad_degree = max(3 * ku - 1, 2 * ku, ku + kq, 2)
        self.quad_degree = quad_degree
        self.tab_v = Tabulation(V.element, d, quad_degree, device=device)
        self.tab_q = Tabulation(Q.element, d, quad_degree, device=device)
        self.geom = CellGeometry(mesh, device=device)
        self.cd_v = torch.as_tensor(V.cell_dofs, dtype=torch.int64,
                                    device=device)
        self.cd_q = torch.as_tensor(Q.cell_dofs, dtype=torch.int64,
                                    device=device)
        self._scatter_v = ScatterAdd(self.cd_v, V.ndof)
        self._scatter_q = ScatterAdd(self.cd_q, Q.ndof)
        wdet = self.tab_v.w[None, :] * self.geom.detj[:, None]
        #: (nc, nq) quadrature weights times |det J|
        self.wdet = wdet
        #: (nc, nq, nloc_v, d) physical gradients of the velocity basis
        self.gtest = torch.einsum("qle,cej->cqlj", self.tab_v.gphi,
                                  self.geom.jinv)
        self._static = None
        self._gd_factors = None
        #: optional forcing (see the class docstring), evaluated at the
        #: velocity rule's physical points ``xq`` (nc, nq, d)
        self.rhs = rhs
        self.xq = (self.geom.quad_points_physical(self.tab_v.ref_pts)
                   if rhs is not None else None)
        self._forcing_cache = (None, None)
        #: optional extra residual hook: fn(z, params) -> (Sv, Sq),
        #: added by :meth:`residual` (the solver's stabilisation)
        self.stabilisation = None

    def restricted(self, cells, cd_v):
        """A copy of this form over the cells ``cells`` (an int tensor on
        its device), in that order, whose velocity dofs are numbered by
        ``cd_v`` (len(cells), nloc_v): the distributed solver's rank-local
        form.  Its per-cell methods (``cell_residual``, the element
        tensors, ``graddiv_factors``, ``forcing``,
        ``pressure_mass_inverse``) run on those cells alone; the global
        assembly (``residual`` and the apply methods) is not its."""
        form = copy.copy(self)
        form.geom = self.geom.restricted(cells)
        form.wdet, form.gtest = self.wdet[cells], self.gtest[cells]
        form.cd_v, form.cd_q = cd_v, None
        form._scatter_v = form._scatter_q = None
        form.xq = None if self.xq is None else self.xq[cells]
        form._static = form._gd_factors = None
        form._forcing_cache = (None, None)
        form.stabilisation = None
        return form

    # ------------------------------------------------------------------
    # per-cell kernels (batched over the leading cell axis)
    # ------------------------------------------------------------------
    def _vel_fields(self, u_loc):
        """u at quad points (nc, nq, d) and grad u (nc, nq, d, d)."""
        u_q = torch.einsum("ql,cld->cqd", self.tab_v.phi, u_loc)
        gu = torch.einsum("cqlj,cli->cqij", self.gtest, u_loc)
        return u_q, gu

    def cell_velocity_residual(self, u_loc, wind_loc, params):
        """Velocity-block residual per cell (nc, nloc_v, d):
        nu (2 sym grad u, grad v) + gamma graddiv + advect ((grad u) wind, v)
        """
        nu, gamma = params["nu"], params["gamma"]
        advect = params.get("advect", 0.0)
        wdet, gtest = self.wdet, self.gtest
        _, gu = self._vel_fields(u_loc)
        S = gu + gu.transpose(-1, -2)
        rv = nu * torch.einsum("cq,cqij,cqlj->cli", wdet, S, gtest)
        divu = torch.diagonal(gu, dim1=-2, dim2=-1).sum(-1)  # (nc, nq)
        if self.graddiv_mode == "cell_avg":
            int_div_test = torch.einsum("cq,cqld->cld", wdet, gtest)
            int_divu = torch.einsum("cq,cq->c", wdet, divu)
            rv = rv + gamma * (int_divu / self.geom.vol)[:, None, None] \
                * int_div_test
        else:
            rv = rv + gamma * torch.einsum("cq,cq,cqld->cld", wdet, divu,
                                           gtest)
        w_q = torch.einsum("ql,cld->cqd", self.tab_v.phi, wind_loc)
        conv = torch.einsum("cqij,cqj->cqi", gu, w_q)
        rv = rv + advect * torch.einsum("cq,cqi,ql->cli", wdet, conv,
                                        self.tab_v.phi)
        return rv

    def forcing(self, params):
        """(f_v (nc, nq, d), f_q (nc, nq)) at the quadrature points, or
        None without ``rhs``.  It depends on nu and advect only, the two
        params the problems' ``rhs`` reads, so it is evaluated once per
        pair of them and kept: every Jacobian action of a Newton step
        reads the same one."""
        if self.rhs is None:
            return None
        key = (float(params["nu"]), float(params.get("advect", 1.0)))
        if self._forcing_cache[0] != key:
            nc, nq, d = self.xq.shape
            f_v, f_q = self.rhs(self.xq.reshape(-1, d), params)
            self._forcing_cache = (key, (f_v.reshape(nc, nq, d),
                                         f_q.reshape(nc, nq)))
        return self._forcing_cache[1]

    def cell_residual(self, u_loc, p_loc, params):
        """Full mixed residual per cell -> (rv (nc, nloc_v, d),
        rq (nc, nloc_q))."""
        wdet, gtest = self.wdet, self.gtest
        rv = self.cell_velocity_residual(u_loc, u_loc, params)
        _, gu = self._vel_fields(u_loc)
        divu = torch.diagonal(gu, dim1=-2, dim2=-1).sum(-1)
        p_q = torch.einsum("ql,cl->cq", self.tab_q.phi, p_loc)
        # -(p, div v)
        rv = rv - torch.einsum("cq,cq,cqld->cld", wdet, p_q, gtest)
        # -(div u, q)
        rq = -torch.einsum("cq,cq,ql->cl", wdet, divu, self.tab_q.phi)
        f = self.forcing(params)
        if f is not None:
            rv = rv - torch.einsum("cq,cqd,ql->cld", wdet, f[0],
                                   self.tab_v.phi)
            rq = rq - torch.einsum("cq,cq,ql->cl", wdet, f[1],
                                   self.tab_q.phi)
        return rv, rq

    # ------------------------------------------------------------------
    # global assembly (out of place, so forward AD passes through)
    # ------------------------------------------------------------------
    def _sum_v(self, rv, like):
        return self._scatter_v(rv.reshape(-1, self.dim),
                               torch.zeros_like(like))

    def _sum_q(self, rq, like):
        return self._scatter_q(rq.reshape(-1), torch.zeros_like(like))

    def residual(self, z, params):
        """Assembled residual (Rv (ndofV, d), Rq (ndofQ,)).

        No boundary conditions applied here (the solver masks rows); the
        ``stabilisation`` hook's (Sv, Sq) is added when set."""
        u, p = z
        rv, rq = self.cell_residual(u[self.cd_v], p[self.cd_q], params)
        Rv, Rq = self._sum_v(rv, u), self._sum_q(rq, p)
        if self.stabilisation is not None:
            Sv, Sq = self.stabilisation(z, params)
            Rv = Rv + Sv
            Rq = Rq + Sq
        return (Rv, Rq)

    # ------------------------------------------------------------------
    # element tensors (for patches / coarse grids), flattened with local
    # index l*d + component
    # ------------------------------------------------------------------
    def _static_velocity_tensors(self):
        """Geometry-only parts of the velocity Jacobian: (K viscous,
        G grad-div) as (nc, nl*d, nl*d), computed once and kept:
        K[(l,i),(m,j)] = delta_ij int g_l . g_m + int g_m[i] g_l[j]."""
        if self._static is None:
            wdet, g = self.wdet, self.gtest
            nc, _, nl, d = g.shape
            eye = torch.eye(d, dtype=real_dtype, device=self.device)
            gg = torch.einsum("cq,cqla,cqma->clm", wdet, g, g)
            K = (gg[:, :, None, :, None] * eye[None, None, :, None, :]
                 + torch.einsum("cq,cqmi,cqlj->climj", wdet, g, g))
            Bt = self.graddiv_factors()
            G = torch.einsum("cip,cjp->cij", Bt, Bt)
            self._static = (K.reshape(nc, nl * d, nl * d), G)
        return self._static

    def advection_element_tensors(self, wind):
        """Advection linearisation N(wind) as (nc, nl*d, nl*d):
        N[(l,i),(m,j)] = delta_ij (phi_l, grad phi_m . w)
                       + (phi_l, d_j w_i phi_m)
        (the jvp of (grad u) u at w: (grad du) w + (grad w) du)."""
        wdet, g, phi = self.wdet, self.gtest, self.tab_v.phi
        nc, _, nl, d = g.shape
        w_loc = wind[self.cd_v]
        w_q = torch.einsum("ql,cld->cqd", phi, w_loc)
        gw = torch.einsum("cqlj,cli->cqij", g, w_loc)  # grad w at q
        adv1 = torch.einsum("cq,ql,cqmd,cqd->clm", wdet, phi, g, w_q)
        eye = torch.eye(d, dtype=real_dtype, device=self.device)
        N = (adv1[:, :, None, :, None] * eye[None, None, :, None, :]
             + torch.einsum("cq,ql,qm,cqij->climj", wdet, phi, phi, gw))
        return N.reshape(nc, nl * d, nl * d)

    def velocity_element_tensors(self, params, wind):
        """(nc, nloc_v*d, nloc_v*d) Newton Jacobian of the velocity block
        at the given wind: nu K + gamma G + advect N(wind)."""
        K, G = self._static_velocity_tensors()
        advect = params.get("advect", 0.0)
        return (params["nu"] * K + params["gamma"] * G
                + advect * self.advection_element_tensors(wind))

    def mixed_element_tensors(self, z, params):
        """Per-cell Jacobian blocks of the mixed residual at state z:
        (Juu, Jup, Jpu, Jpp) of shapes (nc, nlv*d, nlv*d), (nc, nlv*d,
        nlq), (nc, nlq, nlv*d), (nc, nlq, nlq).  The closed forms of
        :meth:`cell_residual`'s Jacobian (the JAX package takes jacfwd of
        it): Juu the velocity block at wind u, Jup[(l,i), m] =
        -int phi_m d_i phi_l, Jpu its transpose, Jpp zero; the forcing
        does not depend on z, and no stabilisation term enters."""
        Juu = self.velocity_element_tensors(params, z[0])
        Jup = self.gradient_element_tensors()
        Jpu = Jup.transpose(1, 2).contiguous()
        nlq = Jup.shape[2]
        return Juu, Jup, Jpu, Juu.new_zeros((Jup.shape[0], nlq, nlq))

    def gradient_element_tensors(self):
        """(nc, nlv*d, nlq) per-cell blocks of B^T, the -(p, div v)
        coupling: [(l,i), m] = -int phi_m d_i phi_l."""
        nc, nq, nl, d = self.gtest.shape
        return -torch.einsum("cq,qm,cqli->clim", self.wdet, self.tab_q.phi,
                             self.gtest).reshape(nc, nl * d, -1)

    # ------------------------------------------------------------------
    # gamma-split structure: per-cell factors of the grad-div term
    # ------------------------------------------------------------------
    def graddiv_factors(self):
        """Static per-cell factors Bt (nc, nloc_v*d, q) with
        G_cell = Bt @ Bt.T = the unit-gamma grad-div element matrix:
        q = 1 for cell_avg; for exact, q = the points of a degree
        2(k-1) rule, which integrates div u div v exactly."""
        if self._gd_factors is None:
            nld = self.tab_v.nloc * self.dim
            if self.graddiv_mode == "cell_avg":
                g = torch.einsum("cq,cqld->cld", self.wdet, self.gtest)
                self._gd_factors = (
                    g / torch.sqrt(self.geom.vol)[:, None, None]
                ).reshape(-1, nld, 1)
            else:
                deg = max(2 * (self.V.element.degree - 1), 0)
                tab = Tabulation(self.V.element, self.dim, deg,
                                 device=self.device)
                gtest = torch.einsum("qle,cej->cqlj", tab.gphi,
                                     self.geom.jinv)
                # div of basis (l, i) at point q is gtest[c, q, l, i]
                sq = torch.sqrt(tab.w[None, :] * self.geom.detj[:, None])
                self._gd_factors = torch.einsum(
                    "cqld,cq->cldq", gtest, sq).reshape(-1, nld, tab.nq)
        return self._gd_factors

    # ------------------------------------------------------------------
    # off-diagonal blocks (for the Schur fieldsplit preconditioner,
    # alfi/solver.py:405-421)
    # ------------------------------------------------------------------
    def apply_pressure_gradient(self, p):
        """B^T p : velocity rows of the -(p, div v) coupling."""
        p_q = torch.einsum("ql,cl->cq", self.tab_q.phi, p[self.cd_q])
        rv = -torch.einsum("cq,cq,cqld->cld", self.wdet, p_q, self.gtest)
        like = torch.empty((self.V.ndof, self.dim), dtype=rv.dtype,
                           device=rv.device)
        return self._sum_v(rv, like)

    def apply_divergence(self, u):
        """B u : pressure rows of the -(div u, q) coupling."""
        _, gu = self._vel_fields(u[self.cd_v])
        divu = torch.diagonal(gu, dim1=-2, dim2=-1).sum(-1)
        rq = -torch.einsum("cq,cq,ql->cl", self.wdet, divu, self.tab_q.phi)
        like = torch.empty((self.Q.ndof,), dtype=rq.dtype, device=rq.device)
        return self._sum_q(rq, like)

    def apply_pressure_massinv(self, minv, r):
        """Mp^{-1} r for a DG pressure space (dofs uniquely cell-owned),
        given per-cell inverse mass matrices ``minv`` (nc, nlq, nlq)."""
        out = torch.einsum("clm,cm->cl", minv, r[self.cd_q])
        return self._sum_q(out, r)

    # ------------------------------------------------------------------
    # auxiliary quantities
    # ------------------------------------------------------------------
    def pressure_mass_inverse(self):
        """Per-cell inverse DG mass matrices (nc, nloc_q, nloc_q) — the
        reference's DGMassInv PC (alfi/solver.py:15-38).  P0 is a scalar
        reciprocal; higher orders invert in f64."""
        tq = self.tab_q
        M = torch.einsum("q,c,ql,qm->clm", tq.w, self.geom.detj, tq.phi,
                         tq.phi)
        if tq.nloc == 1:
            return 1.0 / M
        return torch.linalg.inv(M)

    def pressure_integral(self, p):
        tq = self.tab_q
        p_q = torch.einsum("ql,cl->cq", tq.phi, p[self.cd_q])
        return torch.einsum("q,c,cq->", tq.w, self.geom.detj, p_q)

    def area(self):
        return self.geom.vol.sum()
