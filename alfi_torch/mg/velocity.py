"""Full-multigrid solver for the (nearly singular) AL velocity block.

Replacement for the reference's fieldsplit_0 "almg" branch
(alfi/solver.py:353-379): Richardson(1) wrapping a FULL multigrid cycle
whose level smoother is FGMRES(6 in 2D / 10 in 3D) preconditioned by an
additive star patch smoother, with Schoeberl prolongation and a dense LU
on the coarse grid.

Everything per-Newton-step (coarse winds by injection, per-cell element
tensors, patch inverses, coarse LU) is rebuilt by :meth:`VelocityMG.setup`
from (params, fine wind); the topology (patches, transfers, dof maps) is
static host data turned into device tables once.  The level matvec runs
kernel K2 and the patch smoother kernel K1 (alfi_torch/kernels.py).

This slice ports the uniform-hierarchy choices of the flagship solve:
star patches, additive composition, Schoeberl transfers, FMG cycle,
dense coarse LU, no stabilisation.
"""

from __future__ import annotations

import torch

from ..fem import (
    BCSet,
    FunctionSpace,
    MixedFunctionSpace,
    NSForm,
    VectorFunctionSpace,
    dg_lagrange,
)
from ..kernels import GatherGemvScatter
from ..solvers.batched_lu import coarse_factor, coarse_solve
from ..solvers.krylov import fgmres
from ..solvers.linear import assemble_dense_from_tensors, vector_rows
from .patches import (
    build_patch_solver,
    make_patch_factor_parts,
    patch_static_operators,
    star_patches,
)
from .schoeberl import SchoeberlTransfer
from .transfer import injection, prolongation


class MGLevel:
    def __init__(self, V, form, mask_u, rows, *, device):
        self.V = V
        self.form = form
        self.mask_u = mask_u  # (ndof, d)
        self.mask_flat = mask_u.reshape(-1)
        #: (nc, nloc*d) flattened dof rows
        self.rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
        #: the level matvec's gather-GEMV-scatter (kernel K2)
        self.matvec = GatherGemvScatter(rows, V.ndof * V.value_size, "K2",
                                        device=device)

    def gather_cells(self, v0):
        """(nc, nld) cell-local values from the flat vector ``v0``."""
        return v0[self.rows]

    def sum_cells(self, rloc):
        """Adjoint of gather_cells: accumulate (nc, nld) cell-local
        contributions into a flat (ndof*d,) vector."""
        out = rloc.new_zeros((self.V.ndof * self.V.value_size,))
        return out.index_add(0, self.rows.reshape(-1), rloc.reshape(-1))


class VelocityMG:
    """Geometric MG hierarchy for the velocity block of one solver
    (supplies hierarchy, element, problem BCs, graddiv mode, smoothing
    count, device)."""

    def __init__(self, solver):
        mh = solver.mh
        self.hierarchy = mh
        self.device = solver.device
        problem = solver.problem
        self.smoothing = solver.smoothing
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

        self.prolongs = [
            prolongation(mh, l, spaces[l], spaces[l + 1], device=self.device)
            for l in range(self.nlevels - 1)
        ]
        self.injects = [
            injection(mh, l, spaces[l + 1], spaces[l], device=self.device)
            for l in range(self.nlevels - 1)
        ]
        self.patch_solvers = []
        self.patchsets = []
        self.factor_parts = []
        for l in range(1, self.nlevels):
            lev = self.levels[l]
            ps = star_patches(lev.V, lev.mask_flat.cpu().numpy())
            self.patchsets.append(ps)
            self.patch_solvers.append(build_patch_solver(ps,
                                                         device=self.device))
            self.factor_parts.append(make_patch_factor_parts(ps))
        self.schoeberl = [
            SchoeberlTransfer(self, l) for l in range(self.nlevels - 1)
        ]

    # ------------------------------------------------------------------
    # per-level masked operator from element tensors
    # ------------------------------------------------------------------
    def level_apply(self, l, tensors, v):
        """A_l v on (ndof, d) tensors with eliminated BCs:
        mask * sum_c R_c^T T_c R_c (mask * v) + (1 - mask) * v, the sum
        by kernel K2."""
        lev = self.levels[l]
        mask = lev.mask_u
        v0 = (mask * v).reshape(-1)
        r = lev.matvec(tensors, v0).reshape(lev.V.ndof, self.d)
        return mask * r + (1.0 - mask) * v

    # ------------------------------------------------------------------
    def transfer_setup(self, params, statics):
        """Schoeberl transfer factorisations — depend only on (nu, gamma),
        so the solver computes them ONCE per Reynolds solve (the
        reference's parameter-keyed rebuild cache,
        alfi/transfer.py:168-184).  ``statics``: static_state()'s
        "schoeberl" list."""
        return [t.setup(params, s) for t, s in zip(self.schoeberl, statics)]

    def static_state(self):
        """One-time static patch operators (smoother levels + Schoeberl
        transfers)."""
        levels = [
            patch_static_operators(self.patchsets[l - 1],
                                   self.levels[l].form)
            for l in range(1, self.nlevels)
        ]
        schoeberl = [t.static_ops() for t in self.schoeberl]
        return {"levels": levels, "schoeberl": schoeberl}

    def setup(self, u_fine, params, schoeberl_state, static):
        """Build the per-Newton-step state: winds, tensors, patch
        inverses, coarse factorisation (the split, unstabilised form:
        only the advection part is wind-dependent; the geometry-only
        patch parts come from ``static`` = static_state(), the transfer
        factorisations are ``schoeberl_state`` = transfer_setup())."""
        winds = [None] * self.nlevels
        winds[-1] = u_fine
        for l in range(self.nlevels - 2, -1, -1):
            winds[l] = self.injects[l].apply(winds[l + 1])
        tensors, N_els = [], []
        for l in range(self.nlevels):
            form = self.levels[l].form
            K_el, G_el = form._static_velocity_tensors()
            N_el = form.advection_element_tensors(winds[l])
            M_el = params["nu"] * K_el + params["advect"] * N_el
            tensors.append(M_el + params["gamma"] * G_el)
            N_els.append(N_el)
        patch_lufacs = [
            self.factor_parts[l - 1](static["levels"][l - 1], N_els[l],
                                     params)
            for l in range(1, self.nlevels)
        ]
        lev0 = self.levels[0]
        A0 = assemble_dense_from_tensors(lev0.form, tensors[0], lev0.mask_u)
        return {
            "tensors": tensors,
            "patch_lufacs": patch_lufacs,
            "coarse_fac": coarse_factor(A0),
            "schoeberl": schoeberl_state,
        }

    def _smoother_pc(self, l, state):
        lev = self.levels[l]
        inv = state["patch_lufacs"][l - 1]
        _, papply = self.patch_solvers[l - 1]

        def pc(r):
            mask = lev.mask_u
            x = papply(inv, (mask * r).reshape(-1))
            x = x.reshape(-1, self.d) * mask
            return x + (1.0 - mask) * r

        return pc

    # ------------------------------------------------------------------
    def _coarse_solve(self, state, r):
        lev0 = self.levels[0]
        x = coarse_solve(state["coarse_fac"], r.reshape(-1))
        mask = lev0.mask_u
        return x.reshape(-1, self.d) * mask + (1.0 - mask) * r

    def _smooth(self, l, state, b, x0):
        """Fixed-iteration level smoother: FGMRES(smoothing) + patch PC
        (ksp_convergence_test skip).  ``x0=None`` means a zero initial
        guess (the defect is then ``b`` itself)."""
        tensors = state["tensors"][l]

        def A(v):
            return self.level_apply(l, tensors, v)

        m = self.smoothing
        x, _ = fgmres(A, b, pc=self._smoother_pc(l, state), x0=x0,
                      rtol=0.0, atol=-1.0, maxit=m, restart=m)
        return x

    def _prolong(self, l, state, xc):
        """Correction prolongation coarse level l -> l+1."""
        xf = self.schoeberl[l].prolong(state["schoeberl"][l], xc)
        return self.levels[l + 1].mask_u * xf

    def _restrict(self, l, state, rf):
        """Residual restriction level l+1 -> l: the Schoeberl adjoint only
        behind --restriction, else the standard adjoint (reference
        default)."""
        if self.schoeberl_restriction:
            rc = self.schoeberl[l].restrict(state["schoeberl"][l], rf)
        else:
            rc = self.prolongs[l].apply_transpose(rf)
        return self.levels[l].mask_u * rc

    def vcycle(self, l, state, b, x0):
        """One V-cycle: the smoother block is used both pre and post,
        matching PETSc's default of reusing mg_levels as down/up
        smoother."""
        if l == 0:
            return self._coarse_solve(state, b)
        x = self._smooth(l, state, b, x0)
        r = b - self.level_apply(l, state["tensors"][l], x)
        rc = self._restrict(l - 1, state, r)
        xc = self.vcycle(l - 1, state, rc, None)
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
        zero = one full multigrid cycle)."""

        def solve_A(rv):
            return self.fmg(state, rv)

        return solve_A
