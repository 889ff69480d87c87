"""Full-multigrid solver for the (nearly singular) AL velocity block.

Replacement for the reference's fieldsplit_0 "almg" branch
(alfi/solver.py:353-379): Richardson(1) wrapping a FULL multigrid cycle
whose level smoother is FGMRES(6 in 2D / 10 in 3D) preconditioned by an
additive star patch smoother, with Schoeberl prolongation and a dense LU
on the coarse grid.

Everything per-Newton-step (coarse winds by injection, per-cell element
tensors, per-facet Burman tensors, patch inverses, coarse LU) is rebuilt
by :meth:`VelocityMG.setup` from (params, fine wind, fine pressure); the
topology (patches, transfers, dof maps, the merged level operators'
patterns) is static host data turned into device tables once.  Per
Newton step and level, kernel KA sums the cell tensors (and the Burman
facet tensors) into one merged level operator, which every level apply of
that step reads with kernel KM; the patch smoother runs kernel K1
(alfi_torch/kernels.py).

Ported choices: star and macrostar patches, additive composition or
multiplicative colour sweeps (one K1 table per colour, a KM residual
update between colours), Schoeberl or standard transfers, patch or
Jacobi smoothers under FGMRES or Chebyshev, FMG, V- or W-cycles, dense
coarse LU, SUPG/GLS terms in the level and patch operators, and Burman's
facet terms there (SV).  The grad-div harness (``alfi_torch/graddiv.py``)
takes the Chebyshev-driven W-cycle; the Navier-Stokes solver the
defaults.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..fem import (
    BCSet,
    FunctionSpace,
    MixedFunctionSpace,
    NSForm,
    VectorFunctionSpace,
    dg_lagrange,
)
from ..fem.scatter import ScatterAdd
from ..kernels import MergedLevelOperator
from ..solvers.batched_lu import coarse_factor, coarse_solve, patch_inverses
from ..solvers.krylov import chebyshev, fgmres
from ..solvers.linear import assemble_dense_from_tensors, vector_rows
from ..stabilisation import BurmanStabilisation, make_stabilisation
from .patches import (
    FacetPatchTables,
    assemble_patch_matrices,
    build_multiplicative_solver,
    build_patch_solver,
    contract_patch_facet_tensors,
    macrostar_patches,
    make_patch_factor_parts,
    patch_static_operators,
    star_patches,
)
from .bubble import BubbleTransfer
from .level_operator import LevelPattern
from .schoeberl import SchoeberlTransfer
from .transfer import injection, prolongation


class MGLevel:
    def __init__(self, V, form, mask_u, rows, *, device):
        self.V = V
        self.form = form
        self.mask_u = mask_u  # (ndof, d)
        self.mask_flat = mask_u.reshape(-1)
        #: the mask as bool, True on free dofs
        self.keep = self.mask_flat != 0
        #: (nc, nloc*d) flattened dof rows
        self.rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
        self._scatter = ScatterAdd(self.rows, V.ndof * V.value_size)

    def gather_cells(self, v0):
        """(nc, nld) cell-local values from the flat vector ``v0``."""
        return v0[self.rows]

    def sum_cells(self, rloc):
        """Adjoint of gather_cells: accumulate (nc, nld) cell-local
        contributions into a flat (ndof*d,) vector."""
        return self._scatter(rloc.reshape(-1))


class VelocityMG:
    """Geometric MG hierarchy for the velocity block of one solver
    (supplies hierarchy, element, problem BCs, graddiv mode, smoothing
    count, patch kind, composition, restriction flag, stabilisation,
    device).

    transfer_mode : 'schoeberl' (the robust prolongation, the reference's
        default, alfi/solver.py:588-597) or 'standard' (prolong by the
        point evaluation, restrict by its transpose);
    smoother : 'patch' or 'jacobi' (the operator diagonal, the grad-div
        study's weak baseline, examples/graddiv/graddiv.py:140-147);
    smoother_driver : 'fgmres' (the NS solver) or 'chebyshev' (linear,
        for the grad-div harness's CG);
    cycle : 'full' (FMG, the NS solver), 'v' or 'w'.
    """

    def __init__(self, solver, transfer_mode="schoeberl", smoother="patch",
                 smoother_driver="fgmres", cycle="full"):
        if transfer_mode not in ("schoeberl", "standard"):
            raise ValueError("transfer_mode %r" % transfer_mode)
        if smoother not in ("patch", "jacobi"):
            raise ValueError("smoother %r" % smoother)
        if smoother_driver not in ("fgmres", "chebyshev"):
            raise ValueError("smoother_driver %r" % smoother_driver)
        if cycle not in ("full", "v", "w"):
            raise ValueError("cycle %r" % cycle)
        mh = solver.mh
        self.hierarchy = mh
        self.device = solver.device
        problem = solver.problem
        self.smoothing = solver.smoothing
        self.smoother = smoother
        self.smoother_driver = smoother_driver
        self.cycle = cycle
        #: use the Schoeberl ADJOINT for restriction too (--restriction
        #: flag; default False = standard restriction, matching
        #: alfi/solver.py:592-593)
        self.schoeberl_restriction = solver.restriction
        self.nlevels = len(mh)
        d = mh[0].dim
        self.d = d

        elem = solver.Z.V.element
        self.levels = []
        spaces = []
        for l, mesh in enumerate(mh):
            if l == self.nlevels - 1:
                V = solver.Z.V
                form = solver.form
                mask_u = solver.bcset.mask[0]
            else:
                V = VectorFunctionSpace(mesh, elem)
                Q = FunctionSpace(mesh, dg_lagrange(d, 0))
                Z = MixedFunctionSpace(V, Q)
                form = NSForm(V, Q, graddiv_mode=solver.form.graddiv_mode,
                              device=self.device)
                mask_u = BCSet(Z, problem.bcs(Z), device=self.device).mask[0]
            self.levels.append(MGLevel(V, form, mask_u, vector_rows(V),
                                       device=self.device))
            spaces.append(V)

        # P1FB in 3D needs the bubble flux fix as its "standard" transfer
        # (alfi/transfer.py:334-356); everything else uses plain nodal
        # point evaluation.
        if d == 3 and elem.name == "P1FB" and mh.kind != "bary":
            self.prolongs = [BubbleTransfer(mh, l, device=self.device)
                             for l in range(self.nlevels - 1)]
        else:
            self.prolongs = [
                prolongation(mh, l, spaces[l], spaces[l + 1],
                             device=self.device)
                for l in range(self.nlevels - 1)
            ]
        self.injects = [
            injection(mh, l, spaces[l + 1], spaces[l], device=self.device)
            for l in range(self.nlevels - 1)
        ]
        self.patch_composition = solver.patch_composition
        direction = problem.relaxation_direction()
        self.patch_solvers = []
        self.patchsets = []
        self.factor_parts = []
        patches = (macrostar_patches if solver.patch == "macro"
                   else star_patches)
        # the Jacobi smoother builds no patches (the JAX package builds
        # them and never reads them)
        for l in range(1, self.nlevels if smoother == "patch" else 1):
            lev = self.levels[l]
            ps = patches(lev.V, lev.mask_flat.cpu().numpy())
            if self.patch_composition == "multiplicative":
                # the patches in colour order from here on; their
                # matrices are summed from the whole cell tensors, as
                # the JAX package does for this composition
                ps, factor, sweep = build_multiplicative_solver(
                    ps, direction=direction, device=self.device)
                self.patch_solvers.append((factor, sweep))
                self.factor_parts.append(None)
            else:
                self.patch_solvers.append(build_patch_solver(
                    ps, out_mask=lev.mask_flat, device=self.device))
                self.factor_parts.append(make_patch_factor_parts(ps))
            self.patchsets.append(ps)
        self.schoeberl = None
        if transfer_mode == "schoeberl":
            self.schoeberl = [
                SchoeberlTransfer(self, l) for l in range(self.nlevels - 1)
            ]

        # stabilisation in the level operators: the reference assembles
        # its PCMG/PCPatch operators from the full stabilised Jacobian
        # (advect * stab in the form, alfi/solver.py:204-237, with the
        # wind injected to every level, alfi/stabilisation.py:29-43);
        # without these terms the preconditioner departs from the true
        # Jacobian as Re grows.  One stabilisation per level, on that
        # level's form; the fine level's is the solver's.  Only for a P0
        # pressure, whose injection is the mean of the children.
        self.stab = None
        st = solver.stabilisation
        if (st is not None and st.has_velocity_tensors
                and all(lev.form.Q.element.degree == 0
                        for lev in self.levels)):
            self.stab = [
                make_stabilisation(
                    self.levels[l].form, solver.stabilisation_type,
                    solver.supg_method, solver.supg_magic,
                    solver.stabilisation_weight,
                    char_LU=solver.char_L * solver.char_U)
                for l in range(self.nlevels - 1)] + [st]
            # P0 pressure injection: coarse cell = mean of its children
            self.c2f_cells = [
                torch.as_tensor(mh.coarse_to_fine_cells(l),
                                dtype=torch.int64, device=self.device)
                for l in range(self.nlevels - 1)
            ]

        # Burman's facet coupling in the level operators and patch
        # matrices (the reference assembles the full stabilised Jacobian,
        # dS jump term included, into PCMG/PCPatch): one stabilisation
        # per level, the fine level's the solver's; per level the facet
        # rows (both cells' dofs), which the merged level operator sums
        # in; per patch set the facet tables of the contraction.  The
        # patch matrices are then assembled per Newton step from the whole
        # tensors, so the static K and G patch contractions are not kept.
        self.stab_facet = None
        self.facet_rows = [None] * self.nlevels
        if st is not None and st.has_facet_tensors and smoother == "patch":
            self.stab_facet = [
                (st.impl if l == self.nlevels - 1 else
                 BurmanStabilisation(self.levels[l].form,
                                     weight=st.impl.weight))
                for l in range(self.nlevels)
            ]
            for l, lev in enumerate(self.levels):
                fc = self.stab_facet[l].facets.cells
                rows = lev.rows.cpu().numpy()
                self.facet_rows[l] = np.concatenate(
                    [rows[fc[:, 0]], rows[fc[:, 1]]], axis=1)
            self.patch_facet_tabs = [
                FacetPatchTables(self.patchsets[l - 1],
                                 self.stab_facet[l].facets,
                                 self.levels[l].V)
                for l in range(1, self.nlevels)
            ]
            self.factor_parts = [None] * len(self.factor_parts)

        #: per level the merged level operator (kernels KA and KM), its
        #: pattern the union of the cell and facet blocks' couplings
        self.level_ops = [
            MergedLevelOperator(LevelPattern(
                lev.rows.cpu().numpy(), lev.V.ndof * d, d,
                lev.mask_flat.cpu().numpy(), self.facet_rows[l]),
                device=self.device)
            for l, lev in enumerate(self.levels)]

    # ------------------------------------------------------------------
    # per-level masked operator from element tensors
    # ------------------------------------------------------------------
    def level_assemble(self, l, tensors, ftensors=None):
        """The merged values of level l's operator, summed by kernel KA
        from the cell tensors and, with Burman's stabilisation, the facet
        tensors ``ftensors``: once per level and Newton step."""
        return self.level_ops[l].assemble(tensors, ftensors)

    def level_apply(self, l, vals, v):
        """A_l v on (ndof, d) tensors with eliminated BCs:
        mask * (sum_c R_c^T T_c R_c + sum_f R_f^T F_f R_f) (mask * v)
        + (1 - mask) * v, the facet sum with Burman's stabilisation only,
        in one call of kernel KM on the merged values ``vals`` =
        level_assemble(l, ...)."""
        lev = self.levels[l]
        return self.level_ops[l](vals, v.reshape(-1)).reshape(lev.V.ndof,
                                                              self.d)

    # ------------------------------------------------------------------
    def transfer_setup(self, params, statics=None):
        """Schoeberl transfer factorisations — depend only on (nu, gamma),
        so the solver computes them ONCE per Reynolds solve (the
        reference's parameter-keyed rebuild cache,
        alfi/transfer.py:168-184).  ``statics``: static_state()'s
        "schoeberl" list, or None to factor from the whole cell tensors.
        None with standard transfers."""
        if self.schoeberl is None:
            return None
        if statics is None:
            statics = [None] * len(self.schoeberl)
        return [t.setup(params, s) for t, s in zip(self.schoeberl, statics)]

    def static_state(self):
        """One-time static patch operators (smoother levels + Schoeberl
        transfers)."""
        levels = [
            (patch_static_operators(self.patchsets[l - 1],
                                    self.levels[l].form)
             if self.factor_parts[l - 1] is not None else None)
            for l in range(1, len(self.patchsets) + 1)
        ]
        schoeberl = (None if self.schoeberl is None
                     else [t.static_ops() for t in self.schoeberl])
        return {"levels": levels, "schoeberl": schoeberl}

    def setup(self, u_fine, params, schoeberl_state, static, p_fine=None):
        """Build the per-Newton-step state: winds, tensors, patch
        inverses (or Jacobi diagonals), coarse factorisation (the split
        form: only the advection part, and the stabilisation's where one
        is wired, is wind-dependent; the geometry-only patch parts come
        from ``static`` = static_state(), or with None the patch matrices
        are summed from the whole cell tensors; the transfer
        factorisations are ``schoeberl_state`` = transfer_setup()).  With
        a stabilisation the fine pressure ``p_fine`` is required: its
        terms need the pressure on every level.  With the Chebyshev
        driver, each smoothed level's eigenvalue estimate too."""
        winds = [None] * self.nlevels
        winds[-1] = u_fine
        for l in range(self.nlevels - 2, -1, -1):
            winds[l] = self.injects[l].apply(winds[l + 1])
        if self.stab is not None:
            if p_fine is None:
                raise ValueError("the stabilised level operators need "
                                 "p_fine")
            press = [None] * self.nlevels
            press[-1] = p_fine
            for l in range(self.nlevels - 2, -1, -1):
                press[l] = press[l + 1][self.c2f_cells[l]].mean(dim=1)
            # the frozen (z_last) wind, injected per level like the live one
            fwinds = [None] * self.nlevels
            fwinds[-1] = params["wind"]
            for l in range(self.nlevels - 2, -1, -1):
                fwinds[l] = self.injects[l].apply(fwinds[l + 1])
        tensors, N_els = [], []
        for l in range(self.nlevels):
            form = self.levels[l].form
            K_el, G_el = form._static_velocity_tensors()
            N_el = form.advection_element_tensors(winds[l])
            if self.stab is not None:
                N_el = N_el + self.stab[l].velocity_tensors_hook(
                    (winds[l], press[l]), dict(params, wind=fwinds[l]))
            M_el = params["nu"] * K_el + params["advect"] * N_el
            tensors.append(M_el + params["gamma"] * G_el)
            N_els.append(N_el)
        ftensors = [None] * self.nlevels
        if self.stab_facet is not None:
            # per-level Burman facet Jacobians at the injected winds,
            # advect-scaled like the cell stabilisation terms; the patch
            # matrices from the whole cell tensors plus the facet terms
            ftensors = [
                (params["advect"]
                 * self.stab_facet[l].facet_velocity_tensors(winds[l],
                                                             params)
                 ).contiguous()
                for l in range(self.nlevels)
            ]
            patch_lufacs = [
                patch_inverses(
                    assemble_patch_matrices(self.patchsets[l - 1],
                                            tensors[l])
                    + contract_patch_facet_tensors(
                        self.patch_facet_tabs[l - 1], ftensors[l])
                ).contiguous()
                for l in range(1, self.nlevels)
            ]
        elif self.smoother == "patch":
            patch_lufacs = [
                self.factor_parts[l - 1](static["levels"][l - 1],
                                         N_els[l], params)
                if self.factor_parts[l - 1] is not None and static is not None
                else self.patch_solvers[l - 1][0](tensors[l])
                for l in range(1, self.nlevels)
            ]
        lev0 = self.levels[0]
        A0 = assemble_dense_from_tensors(lev0.form, tensors[0], lev0.mask_u,
                                         facet_tensors=ftensors[0],
                                         facet_rows=self.facet_rows[0])
        # level 0 is solved densely and never applied
        level_ops = [None] + [self.level_assemble(l, tensors[l], ftensors[l])
                              for l in range(1, self.nlevels)]
        if self.smoother == "jacobi":
            # the operator diagonals, read off the merged values
            patch_lufacs = [
                self.level_ops[l].diagonal(level_ops[l]).reshape(-1, self.d)
                for l in range(1, self.nlevels)]
        state = {
            "tensors": tensors,
            "ftensors": ftensors,
            "level_ops": level_ops,
            "patch_lufacs": patch_lufacs,
            "coarse_fac": coarse_factor(A0),
            "schoeberl": schoeberl_state,
        }
        if self.smoother_driver == "chebyshev":
            state["lmax"] = [self._estimate_lmax(l, state)
                             for l in range(1, self.nlevels)]
        return state

    def _smoother_pc(self, l, state):
        """mask * M (mask * r) + (1 - mask) * r: M the additive patch
        inverse, in one call of kernel K1; or the multiplicative sweep,
        one K1 call per colour visit and a KM residual update between
        visits (the sweep's x is zero on masked dofs); or, for the Jacobi
        smoother, r / diag (diag 1 on masked dofs)."""
        inv = state["patch_lufacs"][l - 1]
        if self.smoother == "jacobi":
            return lambda r: r / inv

        _, papply = self.patch_solvers[l - 1]
        if self.patch_composition == "multiplicative":
            vals, op = state["level_ops"][l], self.level_ops[l]
            keep = self.levels[l].keep

            def pc(r):
                r0 = r.reshape(-1)
                x = papply(inv, r0, lambda v: op(vals, v))
                return torch.where(keep, x, r0).reshape(-1, self.d)

            return pc

        def pc(r):
            r0 = r.reshape(-1)
            return papply(inv, r0, r0).reshape(-1, self.d)

        return pc

    def _estimate_lmax(self, l, state, k=10):
        """The largest eigenvalue of the preconditioned level operator,
        as PETSc's GMRES eigenvalue estimate gives it: k Arnoldi steps
        (modified Gram-Schmidt) from the masked ones vector, then
        sigma_max of the (k+1, k) Hessenberg by 20 power iterations on
        H^T H (the JAX package's ``VelocityMG._estimate_lmax``).  A host
        float: one synchronisation per level and set-up."""
        lev = self.levels[l]
        vals = state["level_ops"][l]
        pc = self._smoother_pc(l, state)

        def op(x):
            return pc(self.level_apply(l, vals, x))

        v = lev.mask_u * torch.ones((lev.V.ndof, self.d), dtype=real_dtype,
                                    device=self.device)
        v = v / torch.linalg.norm(v)
        Vs = [v]
        H = torch.zeros((k + 1, k), dtype=real_dtype, device=self.device)
        for j in range(k):
            w = op(Vs[j])
            for i in range(j + 1):
                hij = torch.sum(Vs[i] * w)
                H[i, j] = hij
                w = w - hij * Vs[i]
            hn = torch.linalg.norm(w)
            H[j + 1, j] = hn
            Vs.append(w / (hn + 1e-300))
        x = torch.ones((k,), dtype=real_dtype, device=self.device)
        n = torch.ones((), dtype=real_dtype, device=self.device)
        for _ in range(20):
            y = H.T @ (H @ x)
            n = torch.linalg.norm(y)
            x = y / (n + 1e-300)
        return float(torch.sqrt(n))

    # ------------------------------------------------------------------
    def _coarse_solve(self, state, r):
        lev0 = self.levels[0]
        x = coarse_solve(state["coarse_fac"], r.reshape(-1))
        mask = lev0.mask_u
        return x.reshape(-1, self.d) * mask + (1.0 - mask) * r

    def _smooth(self, l, state, b, x0):
        """Fixed-iteration level smoother: FGMRES(smoothing) + PC
        (ksp_convergence_test skip), or Chebyshev(smoothing) + PC for the
        grad-div harness.  ``x0=None`` means a zero initial guess (the
        defect is then ``b`` itself)."""
        vals = state["level_ops"][l]

        def A(v):
            return self.level_apply(l, vals, v)

        m = self.smoothing
        if self.smoother_driver == "chebyshev":
            return chebyshev(A, b, self._smoother_pc(l, state), x0=x0,
                             maxit=m, lmax=state["lmax"][l - 1])
        x, _ = fgmres(A, b, pc=self._smoother_pc(l, state), x0=x0,
                      rtol=0.0, atol=-1.0, maxit=m, restart=m)
        return x

    def _prolong(self, l, state, xc):
        """Correction prolongation coarse level l -> l+1."""
        if self.schoeberl is None:
            xf = self.prolongs[l].apply(xc)
        else:
            xf = self.schoeberl[l].prolong(state["schoeberl"][l], xc)
        return self.levels[l + 1].mask_u * xf

    def _restrict(self, l, state, rf):
        """Residual restriction level l+1 -> l: the Schoeberl adjoint only
        behind --restriction, else the standard adjoint (reference
        default)."""
        if self.schoeberl is not None and self.schoeberl_restriction:
            rc = self.schoeberl[l].restrict(state["schoeberl"][l], rf)
        else:
            rc = self.prolongs[l].apply_transpose(rf)
        return self.levels[l].mask_u * rc

    def vcycle(self, l, state, b, x0, ncoarse=1):
        """One V-cycle (ncoarse=2: W-cycle, two coarse corrections on
        every level above 1): the smoother block is used both pre and
        post, matching PETSc's default of reusing mg_levels as down/up
        smoother."""
        if l == 0:
            return self._coarse_solve(state, b)
        x = self._smooth(l, state, b, x0)
        for _ in range(ncoarse if l > 1 else 1):
            r = b - self.level_apply(l, state["level_ops"][l], x)
            rc = self._restrict(l - 1, state, r)
            xc = self.vcycle(l - 1, state, rc, None, ncoarse=ncoarse)
            x = x + self._prolong(l - 1, state, xc)
        return self._smooth(l, state, b, x)

    def fmg(self, state, b):
        """Full multigrid (pc_mg_type full): restrict the rhs to every
        level, coarse-solve, then per level prolong + one V-cycle."""
        bs = [None] * self.nlevels
        bs[-1] = b
        for l in range(self.nlevels - 2, -1, -1):
            bs[l] = self._restrict(l, state, bs[l + 1])
        x = self._coarse_solve(state, bs[0])
        for l in range(1, self.nlevels):
            x = self._prolong(l - 1, state, x)
            x = self.vcycle(l, state, bs[l], x)
        return x

    def make_solve_A(self, state):
        """rv -> MG-approximate A^{-1} rv (one Richardson iteration from
        zero = one cycle of the configured kind)."""
        if self.cycle == "full":
            return lambda rv: self.fmg(state, rv)
        ncoarse = 2 if self.cycle == "w" else 1
        return lambda rv: self.vcycle(self.nlevels - 1, state, rv, None,
                                      ncoarse=ncoarse)
