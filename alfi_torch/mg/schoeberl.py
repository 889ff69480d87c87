"""Schoeberl robust prolongation.

Re-design of alfi/transfer.py:91-356 (AutoSchoeberlTransfer + PkP0
subclass): the standard prolongation P is corrected so the prolonged
field stays (nearly) divergence-free inside every coarse cell — without
this the MG velocity solve degrades as gamma grows.

Algebra (with Z = row mask vanishing on the closure of fine facets that
lie on the coarse skeleton, M = additive patch inverse over coarse-cell
patches of the gamma-weighted velocity form a, and A_gd = the
gamma-grad-div-only operator):

    prolong:  u_f = (I - M Z A_gd) P u_c
    restrict: r_c = P^T (I - A_gd Z M) r_f            (exact adjoint)

Matching the reference:
* the patch operator uses a = nu (2 sym grad u, grad v) + gamma graddiv
  with NO advection (alfi/transfer.py:296-309),
* the rhs form is the gamma graddiv term only (bform, :160-162, 303-309),
* patches: all fine cells inside one coarse cell (uniform) or one macro
  group = coarse uniform cell (bary), minus coarse-skeleton dofs
  (fix_coarse_boundaries, :121-158 — here a static mask precomputed from
  ``facet_birth_level``),
* the patch factorisations depend only on (nu, gamma) and are rebuilt
  once per Reynolds number.

The patch solve M runs kernel K1 (alfi_torch/kernels.py) on explicit f64
inverses or, in the f32 cycle, kernel KL on f32 LU factors (the JAX
package's f32 LU solves): an explicit inverse rounded to f32 carries
eps32 / nu into a solution of size 1 / gamma, since the transfer solves
for the grad-div range, where triangular solves with f32 factors keep
the LU's backward stability.  A_gd stays plain torch in f64 and runs
kernel KB on f32 vectors (f64 arithmetic, no TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import mg_f64_keys, real_dtype
from ..kernels import GradDivTerm, PatchLUSolve
from ..solvers.batched_lu import patch_inverses
from .patches import (
    assemble_patch_matrices,
    build_patch_solver,
    cell_patches,
    patch_static_operators,
    static_patch_sum,
)


class SchoeberlTransfer:
    """Transfer between hierarchy levels l (coarse) and l+1 (fine) of a
    VelocityMG."""

    def __init__(self, mg, l):
        self.mg = mg
        self.l = l
        hierarchy = mg.hierarchy
        mesh_f = hierarchy[l + 1]
        mesh_c = hierarchy[l]
        lev_f = mg.levels[l + 1]
        V = lev_f.V
        d = mg.d
        self.fine_level = lev_f
        self.standard = mg.prolongs[l]

        # --- coarse-skeleton dof mask (fix_coarse_boundaries analogue):
        # fine facets whose geometric ancestor existed at the coarse level
        # (this includes the whole domain boundary, birth level 0)
        skel = np.where(mesh_f.facet_birth_level <= mesh_c.level)[0]
        fixed = V.facet_closure_dofs(skel)
        zmask = np.ones((V.ndof, d))
        zmask[fixed] = 0.0
        self.zmask = torch.as_tensor(zmask, dtype=real_dtype,
                                     device=mg.device)

        # --- coarse-cell patches
        _, groups = self._patch_cell_groups(hierarchy, l)
        ps = cell_patches(V, zmask.reshape(-1), groups)
        self.patchset = ps
        self.factor, self.papply = build_patch_solver(ps, device=mg.device)
        #: kernel KL on the patch table (built at the first f32 set-up)
        self.lusolve = None
        #: kernel KB on the fine level's cells, no mask (built at the first
        #: f32 call)
        self._gd_term = None

    @staticmethod
    def _patch_cell_groups(hierarchy, l):
        """(n_patches, cells-per-patch) fine cells of each coarse cell
        (uniform) / macro group (bary)."""
        fine = hierarchy[l + 1]
        d = fine.dim
        if hierarchy.kind == "bary":
            u_fine = hierarchy.uniform_meshes[l + 1]
            u_coarse = hierarchy.uniform_meshes[l]
            nch = u_fine.n_children
            nuc = u_coarse.num_cells
            u = np.arange(nuc, dtype=np.int64)
            fine_u = u[:, None] * nch + np.arange(nch)[None, :]
            groups = (fine_u[:, :, None] * (d + 1)
                      + np.arange(d + 1)[None, None, :]).reshape(nuc, -1)
            return nch * (d + 1), groups
        nch = fine.n_children
        ncc = hierarchy[l].num_cells
        groups = (np.arange(ncc, dtype=np.int64)[:, None] * nch
                  + np.arange(nch)[None, :])
        return nch, groups

    # ------------------------------------------------------------------
    def static_ops(self):
        """One-time patch contraction of the (wind-free) transfer form's
        parts — see mg/patches.py patch_static_operators."""
        return patch_static_operators(self.patchset, self.fine_level.form,
                                      store=self.mg.sdt)

    def setup(self, params, static=None):
        """Per-parameter state of the transfer form (nu viscous + gamma
        graddiv, no advection), its patch matrices from ``static`` =
        static_ops() or, without it, from the whole cell tensors of that
        form (the grad-div harness's route, as in the JAX package): their
        explicit f64 inverses ("lufac"), or under an f32 cycle (but for
        ALFI_TORCH_MG_F64_KEYS) their f64 LU factors stored in f32 ("lu",
        kernel KL's state)."""
        if static is None:
            lev = self.fine_level
            zero_wind = torch.zeros((lev.V.ndof, self.mg.d),
                                    dtype=real_dtype, device=self.mg.device)
            tensors = lev.form.velocity_element_tensors(
                dict(params, advect=0.0), zero_wind)
            A = assemble_patch_matrices(self.patchset, tensors)
        else:
            A = static_patch_sum(static, params)
        if self.mg.cdt != real_dtype and "schoeberl" not in mg_f64_keys():
            if self.lusolve is None:
                self.lusolve = PatchLUSolve(self.patchset.dofs,
                                            self.patchset.nflat,
                                            device=self.mg.device)
            return {"lu": self.lusolve.factor(A, self.mg.cdt),
                    "gamma": params["gamma"]}
        return {"lufac": patch_inverses(A).contiguous(),
                "gamma": params["gamma"]}

    def _apply_gd(self, gamma, v):
        """Raw gamma-grad-div operator via the static low-rank factors
        (no BC handling), in v's dtype: plain torch in f64, kernel KB on
        f32 vectors (the f32 cycle)."""
        lev = self.fine_level
        if v.dtype != real_dtype:
            if self._gd_term is None:
                self._gd_term = GradDivTerm(lev.rows.cpu().numpy(),
                                            lev.V.ndof * self.mg.d,
                                            device=self.mg.device)
            return self._gd_term(self.mg.gd_factors(self.l + 1), gamma,
                                 v.reshape(-1)).reshape(lev.V.ndof,
                                                        self.mg.d)
        Bt = lev.form.graddiv_factors()  # (nc, nld, q)
        vloc = lev.gather_cells(v.reshape(-1))
        t = torch.einsum("clq,cl->cq", Bt, vloc)
        rloc = gamma * torch.einsum("clq,cq->cl", Bt, t)
        return lev.sum_cells(rloc).reshape(lev.V.ndof, self.mg.d)

    def _patch_solve(self, state, r):
        """M (zmask * r) in one call of kernel K1 (explicit inverses) or KL
        (f32 LU factors): the patch table holds no dof whose zmask is 0, so
        M never reads r there.  Inverses kept in f64 under an f32 cycle
        (ALFI_TORCH_MG_F64_KEYS) apply in f64."""
        if "lu" in state:
            x = self.lusolve(state["lu"],
                             r.reshape(-1).to(state["lu"]["lut"].dtype))
        else:
            lufac = state["lufac"]
            x = self.papply(lufac, r.reshape(-1).to(lufac.dtype))
        return x.reshape(-1, self.mg.d).to(r.dtype)

    def prolong(self, state, uc):
        rhs = self.standard.apply(uc)
        tildeu = self._patch_solve(state, self._apply_gd(state["gamma"],
                                                         rhs))
        return rhs - tildeu

    def restrict(self, state, rf):
        t = self._patch_solve(state, rf)
        b = self._apply_gd(state["gamma"], t)
        return self.standard.apply_transpose(rf - b)
