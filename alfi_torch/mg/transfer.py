"""Grid transfers by nodal point evaluation (host-built, device-applied).

Replaces firedrake's prolong/restrict/inject (and the non-nested transfer
plumbing of alfi/bary.py:113-184) with one mechanism: the target space's
dof nodes are located inside source-mesh cells (exact, via the
refinement lineage; host code copied from the JAX package's
``mg/transfer.py``) and the source basis is tabulated there.  The result
is a static row structure

    target[i] = sum_j w[i, j] * source[idx[i, j]]

i.e. a gather + small contraction on the device — prolongation applies
it, restriction applies its transpose (scatter-add), injection is the
same construction with source/target roles swapped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..fem.scatter import ScatterAdd


def _dof_owner_cells(space):
    """(ndof,) index of one cell containing each dof."""
    nd = space.ndof
    owner = np.zeros(nd, dtype=np.int64)
    nc, nloc = space.cell_dofs.shape
    # reversed so the lowest cell index wins (determinism only)
    cells = np.repeat(np.arange(nc, dtype=np.int64)[::-1], nloc)
    owner[space.cell_dofs[::-1].ravel()] = cells
    return owner


def _ref_coords(mesh, cells, x):
    """Reference coordinates of points x (n, d) inside given cells."""
    v = mesh.vertices[mesh.cells[cells]]  # (n, d+1, d)
    J = np.transpose(v[:, 1:, :] - v[:, :1, :], (0, 2, 1))
    return np.einsum("nde,ne->nd", np.linalg.inv(J), x - v[:, 0, :])


def _locate(mesh, cand, x, tol=1e-10):
    """Pick, per row, the candidate cell (n, K) whose reference coords of
    x are inside the simplex; returns (cells, xi)."""
    n, K = cand.shape
    best = np.full(n, -1, dtype=np.int64)
    best_xi = np.zeros((n, mesh.dim))
    best_q = np.full(n, -np.inf)
    for k in range(K):
        c = cand[:, k]
        valid = c >= 0
        xi = np.zeros((n, mesh.dim))
        xi[valid] = _ref_coords(mesh, c[valid], x[valid])
        bary_min = np.minimum(xi.min(axis=1), 1.0 - xi.sum(axis=1))
        q = np.where(valid, bary_min, -np.inf)
        take = q > best_q
        best[take] = c[take]
        best_xi[take] = xi[take]
        best_q[take] = q[take]
    if np.any(best_q < -tol):
        bad = int((best_q < -tol).sum())
        raise RuntimeError(f"{bad} dof points not located in candidates "
                           f"(worst {best_q.min():.2e})")
    return best, best_xi


class PointEvalTransfer:
    """target <- source evaluation operator with transpose (plain torch)."""

    def __init__(self, source_space, target_space, src_cells, ref_xi, *,
                 device):
        self.source = source_space
        self.target = target_space
        idx_np = source_space.cell_dofs[src_cells]
        self.idx = torch.as_tensor(idx_np, dtype=torch.int64,
                                   device=device)  # (ndof_t, nloc_s)
        self._scatter = ScatterAdd(self.idx, source_space.ndof)
        # tabulate(pts) -> (npts, nloc): row i = all source basis values at
        # target dof i's own reference point
        self.w = torch.as_tensor(source_space.element.tabulate(ref_xi),
                                 dtype=real_dtype, device=device)

    def _weights(self, dtype):
        """The weights in the vector's dtype (the f32 cycle transfers in
        f32, as the JAX package does)."""
        return self.w if dtype == self.w.dtype else self.w.to(dtype)

    def apply(self, u_src):
        """Pointwise evaluation: (ndof_t,) or (ndof_t, d) from source."""
        w = self._weights(u_src.dtype)
        if u_src.dim() == 1:
            return torch.einsum("il,il->i", w, u_src[self.idx])
        return torch.einsum("il,ild->id", w, u_src[self.idx])

    def apply_transpose(self, r_tgt):
        """Adjoint (restriction): accumulate weighted rows."""
        w = self._weights(r_tgt.dtype)
        if r_tgt.dim() == 1:
            return self._scatter((w * r_tgt[:, None]).reshape(-1))
        d = r_tgt.shape[1]
        vals = w[:, :, None] * r_tgt[:, None, :]
        return self._scatter(vals.reshape(-1, d))


def _candidates_fine_from_coarse(hierarchy, clevel, owner_fine_cells):
    """Candidate COARSE cells for points owned by given FINE cells."""
    fine = hierarchy[clevel + 1]
    d = fine.dim
    if hierarchy.kind == "bary":
        # fine bary cell -> fine uniform -> coarse uniform -> its d+1
        # coarse bary children
        u_fine = hierarchy.uniform_meshes[clevel + 1]
        cu = u_fine.parent_cell[fine.parent_cell[owner_fine_cells]]
        return cu[:, None] * (d + 1) + np.arange(d + 1)[None, :]
    return fine.parent_cell[owner_fine_cells][:, None]


def prolongation(hierarchy, clevel, coarse_space, fine_space, *, device):
    """fine <- coarse interpolation (firedrake ``prolong`` analogue)."""
    owner = _dof_owner_cells(fine_space)
    cand = _candidates_fine_from_coarse(hierarchy, clevel, owner)
    cells, xi = _locate(hierarchy[clevel], cand,
                        fine_space.dof_coords)
    return PointEvalTransfer(coarse_space, fine_space, cells, xi,
                             device=device)


def injection(hierarchy, clevel, fine_space, coarse_space, *, device):
    """coarse <- fine state subsampling (firedrake ``inject`` analogue);
    used to move the Newton wind to coarse Jacobians."""
    owner = _dof_owner_cells(coarse_space)  # coarse cells
    c2f = hierarchy.coarse_to_fine_cells(clevel)  # (nc_coarse, m)
    cand = c2f[owner]
    cells, xi = _locate(hierarchy[clevel + 1], cand,
                        coarse_space.dof_coords)
    return PointEvalTransfer(fine_space, coarse_space, cells, xi,
                             device=device)
