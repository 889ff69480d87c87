"""Error norms (the JAX package's ``fem/errors.py``).

Only ``divergence_norm`` is ported, the pointwise check of the
Scott-Vogelius discretisation: |div u_h|_0 by a quadrature of the form's
degree plus ``degree_bump``.  The errors against manufactured solutions
(``velocity_errors``, ``pressure_error``) come with the MMS problems,
ROADMAP.md Queue 1 item 10b.
"""

from __future__ import annotations

import torch

from .nsforms import Tabulation


class ErrorComputer:
    def __init__(self, form, degree_bump=3):
        self.form = form
        self.tab_v = Tabulation(form.V.element, form.dim,
                                form.quad_degree + degree_bump,
                                device=form.device)
        g = form.geom
        self.wdet = self.tab_v.w[None, :] * g.detj[:, None]
        self.jinv = g.jinv

    def divergence_norm(self, u):
        gu = torch.einsum("qle,cej,cli->cqij", self.tab_v.gphi, self.jinv,
                          u[self.form.cd_v])
        divu = torch.einsum("cqii->cq", gu)
        return torch.sqrt(torch.einsum("cq,cq,cq->", self.wdet, divu, divu))
