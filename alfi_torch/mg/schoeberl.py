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

The patch solve M runs kernel K1 (alfi_torch/kernels.py); A_gd stays
plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..solvers.batched_lu import patch_inverses
from .patches import (
    _add_diag,
    build_patch_solver,
    cell_patches,
    patch_static_operators,
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
        return patch_static_operators(self.patchset, self.fine_level.form)

    def setup(self, params, static=None):
        """Per-parameter state: patch inverses of the transfer form (nu
        viscous + gamma graddiv, no advection), from ``static`` =
        static_ops() or, without it, from the whole cell tensors of that
        form (the grad-div harness's route, as in the JAX package)."""
        if static is None:
            lev = self.fine_level
            zero_wind = torch.zeros((lev.V.ndof, self.mg.d),
                                    dtype=real_dtype, device=self.mg.device)
            tensors = lev.form.velocity_element_tensors(
                dict(params, advect=0.0), zero_wind)
            return {"lufac": self.factor(tensors), "gamma": params["gamma"]}
        A = _add_diag(params["nu"] * static["K"]
                      + params["gamma"] * static["G"], static["pad_diag"])
        return {"lufac": patch_inverses(A).contiguous(),
                "gamma": params["gamma"]}

    def _apply_gd(self, gamma, v):
        """Raw gamma-grad-div operator via the static low-rank factors
        (no BC handling)."""
        lev = self.fine_level
        Bt = lev.form.graddiv_factors()  # (nc, nld, q)
        vloc = lev.gather_cells(v.reshape(-1))
        t = torch.einsum("clq,cl->cq", Bt, vloc)
        rloc = gamma * torch.einsum("clq,cq->cl", Bt, t)
        return lev.sum_cells(rloc).reshape(lev.V.ndof, self.mg.d)

    def _patch_solve(self, lufac, r):
        """M (zmask * r) in one call of kernel K1: the patch table holds
        no dof whose zmask is 0, so M never reads r there."""
        x = self.papply(lufac, r.reshape(-1))
        return x.reshape(-1, self.mg.d)

    def prolong(self, state, uc):
        rhs = self.standard.apply(uc)
        tildeu = self._patch_solve(state["lufac"],
                                   self._apply_gd(state["gamma"], rhs))
        return rhs - tildeu

    def restrict(self, state, rf):
        t = self._patch_solve(state["lufac"], rf)
        b = self._apply_gd(state["gamma"], t)
        return self.standard.apply_transpose(rf - b)
