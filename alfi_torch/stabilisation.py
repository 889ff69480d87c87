"""Advection stabilisation, ported from the JAX package's
``stabilisation.py``: SUPG and GLS (cell terms, [Pk]^d-P0) and Burman's
interior-penalty jump term (facet terms, the Scott-Vogelius protocol).

Semantics, as in the reference (alfi/stabilisation.py, wired in
alfi/solver.py:202-237):

* the coefficient beta, the strong residual Lu and the SUPG test
  direction (grad v) u use the LIVE state u, so they enter the Newton
  Jacobian through the jvp of the residual;
* only GLS's Lv advects with the FROZEN wind, the velocity of the
  previous Reynolds solution, passed in as ``params["wind"]``;
* the whole term is multiplied by ``advect`` (it vanishes for Stokes);
* Shakib-Hughes-Zohan coefficient
  beta = ((4 |u|^2 / h^2) + magic (4 nu / h^2)^2)^{-1/2}, weight 1.0 (2D)
  / 0.1 (3D), magic 9.0 at the solver level; Turek's coefficient in
  :class:`TurekSUPG`.

The hook returns a full (Rv, Rq) contribution (GLS touches the pressure
rows through grad q).  ``velocity_element_tensors`` gives the per-cell
velocity-block Jacobian of the same residual for the multigrid level and
patch operators; :class:`BurmanStabilisation` gives per-interior-facet
Jacobians instead.  With a forcing (``NSForm.rhs``, the manufactured
solutions) the strong residual is Lu - f; the SUPG test direction depends
on the state, so f enters the Jacobian too.
"""

from __future__ import annotations

import torch

from .config import real_dtype
from .fem.facets import InteriorFacets
from .fem.scatter import ScatterAdd


class ShakibSUPG:
    """SUPG / GLS with the Shakib-Hughes-Zohan coefficient
    (alfi/stabilisation.py:73-97)."""

    def __init__(self, form, mode, magic=9.0, weight=None):
        self.form = form
        self.mode = mode  # 'supg' | 'gls'
        self.magic = magic
        d = form.dim
        self.weight = weight if weight is not None else (
            0.1 if d == 3 else 1.0)
        tv, tq = form.tab_v, form.tab_q
        # reference-element hessians and pressure gradients; the physical
        # ones (Jinv^T H_ref Jinv on affine cells) are contracted per cell
        self.href = torch.as_tensor(
            form.V.element.tabulate_hess(tv.ref_pts), dtype=real_dtype,
            device=form.device)  # (nq, nl, d, d)
        self.gq_ref = tq.gphi  # (nq, nlq, d)
        self.h = form.geom.h  # CellSize

    # ------------------------------------------------------------------
    # batched per-cell kernels
    # ------------------------------------------------------------------
    def aux_global(self, params):
        """Global scalar entering the coefficient (0.0 for Shakib; Turek
        overrides with the domain-averaged frozen-wind speed)."""
        return 0.0

    def aux_partial(self, w_loc, detj, owned):
        """A rank's partial sum for ``aux`` (the distributed solver sums it
        over the ranks and divides by the domain measure); None: no
        reduction needed (Shakib)."""
        return None

    def _beta_batch(self, u_q, h, wdet, params, aux):
        nu = params["nu"]
        h2 = (h ** 2)[:, None]
        w2 = torch.einsum("cqd,cqd->cq", u_q, u_q)
        return (4.0 * w2 / h2
                + self.magic * (4.0 * nu / h2) ** 2) ** (-0.5)

    def _forcing_v(self, params):
        """The form's velocity forcing at the quadrature points (nc, nq,
        d), or None."""
        f = self.form.forcing(params)
        return None if f is None else f[0]

    def residual_local(self, u_loc, p_loc, w_loc, jinv, detj, h, params,
                       aux, f_v=None):
        """Per-cell stabilisation residual from explicit per-cell batches:
        (rv_loc (nc, nl, d), rq_loc (nc, nlq) or None), not advect-scaled;
        ``f_v`` the forcing at the quadrature points (nc, nq, d) or None.
        The basis index l is contracted first, so the (nc, nq, nl, d, d)
        physical-hessian batch never materialises."""
        tv = self.form.tab_v
        href, gq_ref = self.href, self.gq_ref
        nu, advect = params["nu"], params["advect"]
        u_q = torch.einsum("ql,cld->cqd", tv.phi, u_loc)
        gu = torch.einsum("qle,cej,cli->cqij", tv.gphi, jinv, u_loc)
        # Hu[c,q,i,a,b] = sum_l H_phys[c,q,l,a,b] u_loc[c,l,i]
        Hu_ref = torch.einsum("qlde,cli->cqide", href, u_loc)
        Hu = torch.einsum("cqide,cda,ceb->cqiab", Hu_ref, jinv, jinv)
        # div(2 sym grad u)_i = lap u_i + d_i div u
        visc = (torch.einsum("cqiaa->cqi", Hu)
                + torch.einsum("cqaia->cqi", Hu))
        gp = torch.einsum("qle,cej,cl->cqj", gq_ref, jinv, p_loc)
        Lu = -nu * visc + advect * torch.einsum(
            "cqij,cqj->cqi", gu, u_q) + gp
        if f_v is not None:
            Lu = Lu - f_v
        wdet = tv.w[None, :] * detj[:, None]
        beta = self._beta_batch(u_q, h, wdet, params, aux)
        coef = self.weight * wdet * beta  # (nc, nq)
        gtest = torch.einsum("qle,cej->cqlj", tv.gphi, jinv)
        # SUPG test direction (grad v) w with w the LIVE state
        adv_test = torch.einsum("cqlj,cqj->cql", gtest, u_q)
        rv_loc = torch.einsum("cq,cqi,cql->cli", coef, Lu, adv_test)
        rq_loc = None
        if self.mode == "gls":
            # GLS's Lv advects the test function with the FROZEN wind
            w_q = torch.einsum("ql,cld->cqd", tv.phi, w_loc)
            adv_test = torch.einsum("cqlj,cqj->cql", gtest, w_q)
            # Lv for v = phi_l e_i:
            #   (div 2 sym grad v)_j = delta_ij lap phi_l + d_i d_j phi_l
            #   ((grad v) w)_j       = delta_ij (grad phi_l . w)
            # so inner(Lu, Lv) for test (l, i) =
            #   Lu_i (-nu lap phi_l + grad phi_l . w)
            #   + sum_j Lu_j (-nu H[l, i, j])
            K = torch.einsum("cda,cea->cde", jinv, jinv)
            lap = torch.einsum("qlde,cde->cql", href, K)
            cLu = torch.einsum("cq,cqj,cej->cqe", coef, Lu, jinv)
            hess_term = torch.einsum("qlde,cqe,cdi->cli", href, cLu, jinv)
            rv_loc = torch.einsum("cq,cqi,cql->cli", coef, Lu,
                                  -nu * lap + adv_test) \
                + (-nu) * hess_term
            # pressure rows: inner(Lu, grad q)
            rq_loc = torch.einsum("cq,cqj,qle,cej->cl", coef, Lu,
                                  gq_ref, jinv)
        return rv_loc, rq_loc

    def residual_chunk(self):
        """Cells per chunk of :meth:`residual`: about 512 MB for its
        largest batch, the (cells, nq, d, d, d) physical hessians of u
        (5.3 GB at once for the 3D MMS study at nref 3, whose jvp did not
        fit in 80 GB beside the multigrid state)."""
        tv = self.form.tab_v
        return max(1, (512 << 20) // (tv.nq * self.form.dim ** 3 * 8))

    def residual(self, z, params):
        """Assembled (Rv, Rq), not advect-scaled; the cells in chunks of
        :meth:`residual_chunk`, each cell's terms its own, so that the
        peak of the batches (and of their tangents under the Jacobian's
        jvp) is one chunk's."""
        form = self.form
        geom = form.geom
        u, p = z
        u_loc = u[form.cd_v]
        p_loc = p[form.cd_q]
        w_loc = (params["wind"][form.cd_v] if self.mode == "gls"
                 else torch.zeros_like(u_loc))
        aux, f_v = self.aux_global(params), self._forcing_v(params)
        chunk = self.residual_chunk()
        parts = [
            self.residual_local(
                u_loc[c:c + chunk], p_loc[c:c + chunk], w_loc[c:c + chunk],
                geom.jinv[c:c + chunk], geom.detj[c:c + chunk],
                self.h[c:c + chunk], params, aux,
                None if f_v is None else f_v[c:c + chunk])
            for c in range(0, u_loc.shape[0], chunk)]
        rv_loc = torch.cat([rv for rv, _ in parts])
        rq_loc = (None if parts[0][1] is None
                  else torch.cat([rq for _, rq in parts]))
        Rv = form._sum_v(rv_loc, u)
        Rq = (form._sum_q(rq_loc, p) if rq_loc is not None
              else torch.zeros_like(p))
        return Rv, Rq

    # ------------------------------------------------------------------
    # velocity-block element Jacobians (for the MG preconditioner)
    # ------------------------------------------------------------------
    def _beta_cell(self, u_q, hc, params, aux):
        """Per-cell stabilisation coefficient, (nq,) from u_q (nq, d)."""
        nu = params["nu"]
        h2 = hc ** 2
        w2 = torch.einsum("qd,qd->q", u_q, u_q)
        return (4.0 * w2 / h2
                + self.magic * (4.0 * nu / h2) ** 2) ** (-0.5)

    def velocity_element_tensors(self, z, params):
        """(nc, nl*d, nl*d) per-cell velocity-block Jacobian of the
        stabilisation residual at state z, not advect-scaled (the caller
        multiplies by ``advect``, as the residual hook does).

        The reference assembles its PCMG/PCPatch operators from the full
        stabilised Jacobian (alfi/solver.py:204-237), so the level
        operators and patch matrices carry these terms; without them the
        preconditioner drifts from the true Jacobian as Re grows."""
        form = self.form
        u, p = z
        u_loc = u[form.cd_v]
        wind_loc = (params["wind"][form.cd_v] if self.mode == "gls"
                    else torch.zeros_like(u_loc))
        geom = form.geom
        return self.velocity_element_tensors_from(
            params, u_loc, p[form.cd_q], wind_loc, geom.jinv, geom.detj,
            self.h, self.aux_global(params), self._forcing_v(params))

    def velocity_element_tensors_from(self, params, u_loc, p_loc,
                                      wind_loc, jinv, detj, h, aux,
                                      f_v=None):
        """The same per-cell Jacobians from explicit per-cell batches
        (``f_v``: the forcing at the quadrature points, or None).  SUPG
        with the Shakib coefficient (the production path) uses the
        hand-derived product rule of :meth:`_vet_supg_analytic`; GLS and
        Turek use jacfwd of a per-cell residual."""
        if self.mode == "supg" and type(self) is ShakibSUPG:
            return self._vet_supg_analytic(params, u_loc, p_loc, jinv,
                                           detj, h, f_v)
        return self._vet_jacfwd(params, u_loc, p_loc, wind_loc, jinv,
                                detj, h, aux, f_v)

    def _vet_supg_analytic(self, params, u_loc, p_loc, jinv, detj, h,
                           f_v=None, chunk=None):
        """Analytic per-cell SUPG velocity-block Jacobian.

        rv[l,i] = sum_q coef(q) Lu[q,i] at[q,l] with
          coef = weight * w_q * detj * beta(u),
          Lu   = -nu*(lap u + grad div u) + advect*(grad u) u + grad p
                 (- f with a forcing),
          at   = (grad phi_l) . u_q.
        The product rule in ul[m,n] gives five terms (A: dcoef, B1/B3:
        delta_in viscous and advective parts, B2: basis-hessian part, B4:
        dgu part, C: dat part), each a q-contraction of small per-cell
        factors.  Cells run in chunks of ``chunk`` (default: about 24 MB
        of (chunk, nq, nl, d) working set, at most 2048 cells) to bound
        the peak intermediates."""
        form = self.form
        tv = form.tab_v
        if chunk is None:
            per = tv.nq * tv.nloc * form.dim * 8
            chunk = min(2048, max(256, (24 << 20) // per))
        nu, advect = params["nu"], params["advect"]
        phi, gphi, wq = tv.phi, tv.gphi, tv.w
        href, gq_ref = self.href, self.gq_ref
        weight, magic = self.weight, self.magic
        nc, nl = u_loc.shape[0], u_loc.shape[1]
        d = form.dim
        eye = torch.eye(d, dtype=u_loc.dtype, device=u_loc.device)

        def chunk_J(ul, pl, ji, dj, hc, fc):
            u_q = torch.einsum("ql,cld->cqd", phi, ul)
            g = torch.einsum("qle,cej->cqlj", gphi, ji)
            at = torch.einsum("cqlj,cqj->cql", g, u_q)
            gu = torch.einsum("cqlj,cli->cqij", g, ul)
            K = torch.einsum("cda,cea->cde", ji, ji)
            lap = torch.einsum("qlde,cde->cql", href, K)
            lap_u = torch.einsum("cql,cli->cqi", lap, ul)
            v_le = torch.einsum("cea,cla->cle", ji, ul)
            t_qd = torch.einsum("qlde,cle->cqd", href, v_le)
            gdiv_u = torch.einsum("cqd,cdi->cqi", t_qd, ji)
            visc = lap_u + gdiv_u
            gp = torch.einsum("qle,cej,cl->cqj", gq_ref, ji, pl)
            Lu = (-nu * visc
                  + advect * torch.einsum("cqij,cqj->cqi", gu, u_q) + gp)
            if fc is not None:
                Lu = Lu - fc
            wdet = wq[None, :] * dj[:, None]
            h2 = (hc ** 2)[:, None]
            w2 = torch.einsum("cqd,cqd->cq", u_q, u_q)
            beta = (4.0 * w2 / h2
                    + magic * (4.0 * nu / h2) ** 2) ** (-0.5)
            coef = weight * wdet * beta  # (c, q)
            # dcoef[q,(m,n)] = s[q] u_q[q,n] phi[q,m],
            # s = -4 coef beta^2 / h^2   (d beta = -4 beta^3 u_n/h^2)
            s = -4.0 * coef * beta ** 2 / h2

            # A: dcoef term
            T = torch.einsum("cq,cqi,cql->cqil", s, Lu, at)
            S = torch.einsum("cqn,qm->cqnm", u_q, phi)
            J = torch.einsum("cqil,cqnm->climn", T, S)
            # B1+B3: delta_in (viscous-laplacian + advective) parts
            W = coef[:, :, None] * (-nu * lap + advect * at)
            D = torch.einsum("cqm,cql->clm", W, at)
            J = J + D[:, :, None, :, None] * eye[None, None, :, None, :]
            # B2: basis-hessian part -nu sum_q coef H_phys[q,m,i,n] at[q,l]
            Wc = coef[:, :, None] * at  # (c, q, l)
            X = torch.einsum("qmde,cql->cmdel", href, Wc)
            J = J + (-nu) * torch.einsum("cmdel,cdi,cen->climn",
                                         X, ji, ji)
            # B4: dgu part  advect sum_q coef gu[q,i,n] at[q,l] phi[q,m]
            G = advect * coef[:, :, None, None] * gu  # (c, q, i, n)
            T4 = torch.einsum("cqin,cql->cqinl", G, at)
            J = J + torch.einsum("cqinl,qm->climn", T4, phi)
            # C: dat part  sum_q coef Lu[q,i] g[q,l,n] phi[q,m]
            T5 = torch.einsum("cq,cqi,cqln->cqiln", coef, Lu, g)
            J = J + torch.einsum("cqiln,qm->climn", T5, phi)
            return J  # (c, l, i, m, n)

        J = torch.cat([
            chunk_J(u_loc[c:c + chunk], p_loc[c:c + chunk],
                    jinv[c:c + chunk], detj[c:c + chunk], h[c:c + chunk],
                    None if f_v is None else f_v[c:c + chunk])
            for c in range(0, nc, chunk)])
        return J.reshape(nc, nl * d, nl * d)

    def _vet_jacfwd(self, params, u_loc, p_loc, wind_loc, jinv, detj, h,
                    aux, f_v=None):
        """Per-cell Jacobians by torch.func.jacfwd (GLS and Turek)."""
        tv = self.form.tab_v
        nu, advect = params["nu"], params["advect"]
        phi, gphi, wq = tv.phi, tv.gphi, tv.w
        href, gq_ref = self.href, self.gq_ref
        gls = self.mode == "gls"

        if f_v is None:
            f_v = u_loc.new_zeros((u_loc.shape[0], tv.nq, u_loc.shape[2]))

        def cell_rv(ul, pl, wl, ji, dj, hc, fq):
            u_q = torch.einsum("ql,ld->qd", phi, ul)
            g = torch.einsum("qle,ej->qlj", gphi, ji)
            gu = torch.einsum("qlj,li->qij", g, ul)
            # div(2 sym grad u)_i = lap u_i + d_i(div u) from the
            # reference hessian tabulation
            K = torch.einsum("da,ea->de", ji, ji)
            lap = torch.einsum("qlde,de->ql", href, K)
            lap_u = torch.einsum("ql,li->qi", lap, ul)
            v_le = torch.einsum("ea,la->le", ji, ul)
            t_qd = torch.einsum("qlde,le->qd", href, v_le)
            graddiv_u = torch.einsum("qd,di->qi", t_qd, ji)
            visc = lap_u + graddiv_u
            gp = torch.einsum("qle,ej,l->qj", gq_ref, ji, pl)
            Lu = (-nu * visc
                  + advect * torch.einsum("qij,qj->qi", gu, u_q) + gp
                  - fq)
            beta = self._beta_cell(u_q, hc, params, aux)
            coef = self.weight * (wq * dj) * beta  # (nq,)
            if gls:
                w_q = torch.einsum("ql,ld->qd", phi, wl)
                adv_w = torch.einsum("qlj,qj->ql", g, w_q)
                cLu = torch.einsum("q,qj,ej->qe", coef, Lu, ji)
                A_ld = torch.einsum("qlde,qe->ld", href, cLu)
                hess_term = torch.einsum("ld,di->li", A_ld, ji)
                return (torch.einsum("q,qi,ql->li", coef, Lu,
                                     -nu * lap + adv_w)
                        + (-nu) * hess_term)
            adv_test = torch.einsum("qlj,qj->ql", g, u_q)
            return torch.einsum("q,qi,ql->li", coef, Lu, adv_test)

        J = torch.func.vmap(torch.func.jacfwd(cell_rv, argnums=0))(
            u_loc, p_loc, wind_loc, jinv, detj, h, f_v)
        nc, nl, d = J.shape[0], J.shape[1], J.shape[2]
        return J.reshape(nc, nl * d, nl * d)


class TurekSUPG(ShakibSUPG):
    """Turek's SUPG coefficient (alfi/stabilisation.py:100-136):
    Re_tau = cell_avg(|u|) h Re;  beta = magic h 2 Re_tau / (w_avg (1+Re_tau))
    with w_avg = (1/|Omega|) int |wind| dx over the FROZEN wind."""

    def __init__(self, form, mode, char_LU=1.0, magic=1.0, weight=None):
        super().__init__(form, mode, magic=magic, weight=weight)
        self.char_LU = char_LU
        self._wdet = form.tab_v.w[None, :] * form.geom.detj[:, None]
        self._domain_measure = float(form.area())

    def aux_global(self, params):
        """Global scalar w_avg from the frozen wind (not differentiated)."""
        form = self.form
        w_qq = torch.einsum("ql,cld->cqd", form.tab_v.phi,
                            params["wind"][form.cd_v])
        return torch.einsum(
            "cq,cq->", self._wdet,
            torch.sqrt(torch.einsum("cqd,cqd->cq", w_qq, w_qq))
        ) / self._domain_measure

    def aux_partial(self, w_loc, detj, owned):
        """The owned cells' part of the w_avg numerator, from the frozen
        wind's cell values ``w_loc`` (nc, nl, d), ``detj`` (nc,) and the
        owned-cell mask ``owned`` (nc,)."""
        tv = self.form.tab_v
        w_q = torch.einsum("ql,cld->cqd", tv.phi, w_loc)
        wdet = tv.w[None, :] * detj[:, None]
        s = torch.einsum("cq,cq->c", wdet,
                         torch.sqrt(torch.einsum("cqd,cqd->cq", w_q, w_q)))
        return torch.sum(torch.where(owned, s, 0.0))

    def _beta_batch(self, u_q, h, wdet, params, aux):
        Re = self.char_LU / params["nu"]
        # cell average of |u| (live state); aux = frozen-wind w_avg
        unorm = torch.sqrt(torch.einsum("cqd,cqd->cq", u_q, u_q))
        cellavg = (torch.einsum("cq,cq->c", wdet, unorm)
                   / (wdet.sum(dim=1) + 1e-300))
        re_tau = cellavg * h * Re
        beta = self.magic * h * 2.0 * re_tau / (aux * (1.0 + re_tau)
                                                + 1e-300)
        return beta[:, None] * torch.ones_like(unorm)

    def _beta_cell(self, u_q, hc, params, aux):
        Re = self.char_LU / params["nu"]
        w = self.form.tab_v.w
        unorm = torch.sqrt(torch.einsum("qd,qd->q", u_q, u_q))
        # detj cancels between numerator and denominator (affine cells)
        cellavg = torch.einsum("q,q->", w, unorm) / w.sum()
        re_tau = cellavg * hc * Re
        beta = (self.magic * hc * 2.0 * re_tau
                / (aux * (1.0 + re_tau) + 1e-300))
        return beta * torch.ones_like(unorm)


class BurmanStabilisation:
    """Interior-penalty jump stabilisation (alfi/stabilisation.py:139-162):

        sum_F 0.5 weight h_F^2 beta_F int_F [grad u . n] . [grad v . n]

    with beta_F the facet average of sqrt(|u|^2 + 1e-10) on the LIVE
    state (so it enters the Newton Jacobian), h_F the facet measure in
    2D and its square root in 3D.  The facet sums are out-of-place
    scatter-adds (:class:`~alfi_torch.fem.scatter.ScatterAdd`) so that
    ``torch.func.jvp`` passes through."""

    def __init__(self, form, weight=None):
        self.form = form
        self.weight = weight if weight is not None else 3e-3
        self.facets = InteriorFacets(form.V, 2 * form.V.element.degree,
                                     device=form.device)
        cd = form.V.cell_dofs
        fc = self.facets.cells

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int64, device=form.device)

        #: (nif, nloc) scalar dofs of each side's cell
        self.dofs0, self.dofs1 = dev(cd[fc[:, 0]]), dev(cd[fc[:, 1]])
        self._scatter0 = ScatterAdd(self.dofs0, form.V.ndof)
        self._scatter1 = ScatterAdd(self.dofs1, form.V.ndof)
        self._fstat = None

    def facet_statics(self):
        """Per-facet static tensors: side tabulations, physical gradients,
        normals and the state-independent coefficient."""
        if self._fstat is None:
            fa = self.facets
            dev = self.form.device
            jinv = self.form.geom.jinv
            c0, c1 = (torch.as_tensor(fa.cells[:, s], device=dev)
                      for s in (0, 1))
            k0, k1 = (torch.as_tensor(fa.config[:, s], device=dev)
                      for s in (0, 1))
            self._fstat = dict(
                t0=fa.tab[k0], t1=fa.tab[k1],
                g0=torch.einsum("fqle,fej->fqlj", fa.gtab[k0], jinv[c0]),
                g1=torch.einsum("fqle,fej->fqlj", fa.gtab[k1], jinv[c1]),
                n=fa.normal,
                coefc=0.5 * self.weight * fa.harea ** 2 * fa.scale,
            )
        return self._fstat

    def residual_pairs(self, u0_loc, u1_loc, st):
        """Per-facet residual pair (r0, r1), each (nif, nloc, d), from the
        two sides' cell-local values."""
        w = self.facets.w
        t0, t1, g0, g1, n = st["t0"], st["t1"], st["g0"], st["g1"], \
            st["n"]
        u0 = torch.einsum("fql,fld->fqd", t0, u0_loc)
        u1 = torch.einsum("fql,fld->fqd", t1, u1_loc)
        gu0 = torch.einsum("fqlj,fld->fqdj", g0, u0_loc)
        gu1 = torch.einsum("fqlj,fld->fqdj", g1, u1_loc)
        jump = torch.einsum("fqdj,fj->fqd", gu0 - gu1, n)
        # beta = facet average of sqrt(|u|^2 + 1e-10) (the sides agree
        # for a continuous u; averaged anyway, as avg() does)
        sp0 = torch.sqrt(torch.einsum("fqd,fqd->fq", u0, u0) + 1e-10)
        sp1 = torch.sqrt(torch.einsum("fqd,fqd->fq", u1, u1) + 1e-10)
        beta = 0.5 * (torch.einsum("q,fq->f", w, sp0)
                      + torch.einsum("q,fq->f", w, sp1)) / w.sum()
        coef = st["coefc"] * beta  # (nif,)
        tn0 = torch.einsum("fqlj,fj->fql", g0, n)
        tn1 = torch.einsum("fqlj,fj->fql", g1, n)
        r0 = torch.einsum("f,q,fqd,fql->fld", coef, w, jump, tn0)
        r1 = -torch.einsum("f,q,fqd,fql->fld", coef, w, jump, tn1)
        return r0, r1

    def residual(self, z, params):
        """Assembled (Rv, Rq), not advect-scaled; Rq is zero."""
        u, p = z
        d = self.form.dim
        r0, r1 = self.residual_pairs(u[self.dofs0], u[self.dofs1],
                                     self.facet_statics())
        Rv = self._scatter1(r1.reshape(-1, d),
                            self._scatter0(r0.reshape(-1, d),
                                           torch.zeros_like(u)))
        return Rv, torch.zeros_like(p)

    def facet_velocity_tensors(self, u, params):
        """(nif, 2*nld, 2*nld) per-interior-facet velocity Jacobian of the
        residual at state ``u``, not advect-scaled; row and column blocks
        [side-0 cell dofs, side-1 cell dofs], each in the (l*d +
        component) flattening of the level row maps.  beta uses the LIVE
        state, so this is the jacfwd of a per-facet kernel mirroring
        :meth:`residual`, d(beta)/du included."""
        u01 = torch.stack([u[self.dofs0], u[self.dofs1]], dim=1)
        return self.facet_velocity_tensors_from(u01, self.facet_statics())

    def facet_velocity_tensors_from(self, u01, st):
        """The same Jacobians from an explicit (nif, 2, nloc, d) batch."""
        w = self.facets.w
        wsum = w.sum()

        def kern(uu, t0f, g0f, t1f, g1f, n, cf):
            u0l, u1l = uu[0], uu[1]
            uq0 = torch.einsum("ql,ld->qd", t0f, u0l)
            uq1 = torch.einsum("ql,ld->qd", t1f, u1l)
            gu0 = torch.einsum("qlj,ld->qdj", g0f, u0l)
            gu1 = torch.einsum("qlj,ld->qdj", g1f, u1l)
            jump = torch.einsum("qdj,j->qd", gu0 - gu1, n)
            sp0 = torch.sqrt(torch.einsum("qd,qd->q", uq0, uq0) + 1e-10)
            sp1 = torch.sqrt(torch.einsum("qd,qd->q", uq1, uq1) + 1e-10)
            coef = cf * (0.5 * (w @ sp0 + w @ sp1) / wsum)
            tn0 = torch.einsum("qlj,j->ql", g0f, n)
            tn1 = torch.einsum("qlj,j->ql", g1f, n)
            r0 = coef * torch.einsum("q,qd,ql->ld", w, jump, tn0)
            r1 = -coef * torch.einsum("q,qd,ql->ld", w, jump, tn1)
            return torch.stack([r0, r1], dim=0)  # (2, nl, d)

        J = torch.func.vmap(torch.func.jacfwd(kern))(
            u01, st["t0"], st["g0"], st["t1"], st["g1"], st["n"],
            st["coefc"])
        nif = J.shape[0]
        nld = J.shape[2] * J.shape[3]
        return J.reshape(nif, 2 * nld, 2 * nld)


class StabilisationWrapper:
    """Adapts a stabilisation to the NSForm hook and the solver's
    lifecycle."""

    def __init__(self, impl):
        self.impl = impl

    def residual_hook(self, z, params):
        advect = params["advect"]
        Rv, Rq = self.impl.residual(z, params)
        return advect * Rv, advect * Rq

    @property
    def has_velocity_tensors(self):
        """True when per-cell velocity-block Jacobians are available for
        the MG preconditioner (SUPG/GLS)."""
        return isinstance(self.impl, ShakibSUPG)

    @property
    def has_facet_tensors(self):
        """True when per-interior-facet velocity Jacobians are available
        for the MG preconditioner (Burman, see
        BurmanStabilisation.facet_velocity_tensors)."""
        return isinstance(self.impl, BurmanStabilisation)

    def velocity_tensors_hook(self, z, params):
        """Un-advect-scaled per-cell Jacobian contribution (see
        ShakibSUPG.velocity_element_tensors)."""
        return self.impl.velocity_element_tensors(z, params)

    def update(self, wind):
        # the frozen wind travels through params["wind"]; nothing cached
        pass


def make_stabilisation(form, kind, supg_method, supg_magic, weight,
                       char_LU=1.0):
    if kind in ("supg", "gls"):
        if supg_method == "shakib":
            impl = ShakibSUPG(form, kind, magic=supg_magic, weight=weight)
        elif supg_method == "turek":
            impl = TurekSUPG(form, kind, char_LU=char_LU,
                             magic=supg_magic, weight=weight)
        else:
            raise NotImplementedError(f"supg_method {supg_method!r}")
    elif kind == "burman":
        impl = BurmanStabilisation(form, weight=weight)
    else:
        raise ValueError(kind)
    return StabilisationWrapper(impl)
