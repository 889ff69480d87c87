"""Vertex-star and coarse-cell patch smoothers (host tables + device apply).

Replacement for PETSc's PCPatch + the reference's topological patch
constructors (alfi/relaxation.py Star/MacroStar, configured at
alfi/solver.py:313-344):

* host (numpy, copied from the JAX package's ``mg/patches.py``):
  enumerate star(v) for every vertex — all unconstrained velocity dofs on
  entities CONTAINING v — pad to the max patch size, and precompute, per
  (patch, adjacent cell), the cell-local -> patch-local index map;
* device: patch operators are summed out of the SAME per-cell element
  tensors used everywhere else, inverted in f64, and applied additively
  (no partition of unity, matching patch_pc_patch_partition_of_unity
  False) by the hand-written gather-GEMV-scatter kernels (kernel K1,
  alfi_torch/kernels.py).

Padding goes to dump slots (row m of an (m+1)-sized accumulator, flat dof
index ndof*d, which the kernels read as 0) so every shape is static.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import index_dtype
from ..kernels import GatherGemvScatter
from ..solvers.batched_lu import patch_inverses


def _csr_from_pairs(keys, vals, nkeys):
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    starts = np.searchsorted(keys, np.arange(nkeys + 1))
    return starts, vals


def _pad_csr(starts, vals, fill):
    n = len(starts) - 1
    counts = np.diff(starts)
    m = int(counts.max()) if n else 0
    out = np.full((n, m), fill, dtype=np.int64)
    idx = np.arange(len(vals)) - np.repeat(starts[:-1], counts)
    out[np.repeat(np.arange(n), counts), idx] = vals
    return out, counts


def star_patch_dofs(space, seed_vertices=None):
    """Scalar dofs in star(v) per vertex (padded), + adjacent cells.

    Returns (patch_dofs (np, m) padded with -1, sizes (np,),
             patch_cells (np, mc) padded with -1, cell_counts)."""
    mesh = space.mesh
    if seed_vertices is None:
        seed_vertices = np.arange(mesh.num_vertices, dtype=np.int64)
    nv = mesh.num_vertices

    pair_k, pair_d = [], []
    if space.n_per_vertex:
        pair_k.append(np.arange(nv, dtype=np.int64))
        pair_d.append(space.off_v + np.arange(nv, dtype=np.int64))
    npe = space.n_per_edge
    if npe:
        ev = space.mesh.edge_vertices if mesh.dim == 3 else mesh.facet_vertices
        ne = ev.shape[0]
        for j in range(ev.shape[1]):
            for t in range(npe):
                pair_k.append(ev[:, j].astype(np.int64))
                pair_d.append(space.off_e
                              + np.arange(ne, dtype=np.int64) * npe + t)
    npf = space.n_per_facet
    if npf:
        fv = mesh.facet_vertices
        nf = fv.shape[0]
        for j in range(fv.shape[1]):
            for t in range(npf):
                pair_k.append(fv[:, j].astype(np.int64))
                pair_d.append(space.off_f
                              + np.arange(nf, dtype=np.int64) * npf + t)
    npc = space.n_per_cell
    if npc:
        cells = mesh.cells
        nc = mesh.num_cells
        for j in range(cells.shape[1]):
            for t in range(npc):
                pair_k.append(cells[:, j].astype(np.int64))
                pair_d.append(space.off_c
                              + np.arange(nc, dtype=np.int64) * npc + t)
    keys = np.concatenate(pair_k)
    vals = np.concatenate(pair_d)
    starts, vals = _csr_from_pairs(keys, vals, nv)
    dofs, sizes = _pad_csr(starts, vals, -1)

    # vertex -> cells
    cells = mesh.cells
    ck = cells.ravel().astype(np.int64)
    cv = np.repeat(np.arange(mesh.num_cells, dtype=np.int64),
                   cells.shape[1])
    cstarts, cvals = _csr_from_pairs(ck, cv, nv)
    pcells, ccounts = _pad_csr(cstarts, cvals, -1)

    return (dofs[seed_vertices], sizes[seed_vertices],
            pcells[seed_vertices], ccounts[seed_vertices])


def _rowwise_member_index(sorted_rows, queries, dump):
    """For each row: position of query values inside that row's sorted
    list, or ``dump`` when absent.  sorted_rows (n, m) padded with a
    sentinel larger than any value; queries (n, ...)."""
    n, m = sorted_rows.shape
    q = queries.reshape(n, -1)
    stride = np.int64(sorted_rows.max()) + 2
    flat_rows = (sorted_rows + np.arange(n, dtype=np.int64)[:, None]
                 * stride).ravel()
    flat_q = q + np.arange(n, dtype=np.int64)[:, None] * stride
    pos = np.searchsorted(flat_rows, flat_q.ravel()).reshape(q.shape)
    local = pos - np.arange(n, dtype=np.int64)[:, None] * m
    valid = (local >= 0) & (local < m)
    safe = np.clip(pos, 0, n * m - 1)
    found = valid & (flat_rows[safe] == flat_q)
    return np.where(found, local, dump).reshape(queries.shape)


def star_patches(space, mask_flat, seed_vertices=None):
    """Vertex-star patches (PCPatch construct_type star, dim 0)."""
    sdofs, _, pcells, _ = star_patch_dofs(space, seed_vertices)
    ps = PatchSet(space, mask_flat, sdofs, pcells)
    seeds = (seed_vertices if seed_vertices is not None
             else np.arange(space.mesh.num_vertices))
    ps.seed_points = space.mesh.vertices[seeds]
    return ps


def macrostar_patches(space, mask_flat):
    """MacroStar patches on an Alfeld/bary mesh
    (alfi/relaxation.py:163-177): for each MACRO vertex v,
    star(v) enlarged by the stars of the centroid (non-macro) vertices of
    every coarse cell adjacent to v.  Needed so the smoother captures the
    divergence-free kernel of the Scott-Vogelius AL velocity block."""
    mesh = space.mesh
    d = mesh.dim
    macro = np.where(mesh.macro_vertices)[0]
    nvp = int(mesh.macro_vertices.sum())
    sdofs_all, _, pcells_all, _ = star_patch_dofs(space)
    adj = pcells_all[macro]  # bary cells adjacent to each macro vertex
    padj = np.where(adj >= 0, adj // (d + 1), -1)  # parent (macro) cells
    padj, _ = _merge_scalar_dofs(
        padj, None, np.full((padj.shape[0], 0), -1, dtype=np.int64))
    # centroid vertex of parent cell u has id nvp + u (alfeld layout)
    cent = np.where(padj >= 0, nvp + padj, 0)
    ext = sdofs_all[cent].reshape(len(macro), -1)
    ext = np.where(np.repeat(padj >= 0, sdofs_all.shape[1], axis=1),
                   ext, -1)
    sdofs, _ = _merge_scalar_dofs(sdofs_all[macro], None, ext)
    # patch cells: all d+1 bary children of every adjacent parent cell
    cells = np.where(padj[:, :, None] >= 0,
                     padj[:, :, None] * (d + 1) + np.arange(d + 1),
                     -1).reshape(len(macro), -1)
    ps = PatchSet(space, mask_flat, sdofs, cells)
    ps.seed_points = mesh.vertices[macro]
    return ps


def cell_patches(space, mask_flat, patch_cells):
    """Patches spanning explicit cell groups — the engine of the Schoeberl
    transfer (CoarseCellPatches / CoarseCellMacroPatches,
    alfi/transfer.py:13-88): patch p owns all dofs of
    cells ``patch_cells[p]`` except those masked out by ``mask_flat``."""
    patch_cells = np.asarray(patch_cells, dtype=np.int64)
    cd = space.cell_dofs.astype(np.int64)
    sdofs = cd[np.clip(patch_cells, 0, None)].reshape(
        patch_cells.shape[0], -1)
    sdofs = np.where((patch_cells >= 0).repeat(cd.shape[1], axis=1),
                     sdofs, -1)
    # dedup per row
    sdofs, _ = _merge_scalar_dofs(
        sdofs, None, np.full((sdofs.shape[0], 0), -1, dtype=np.int64))
    return PatchSet(space, mask_flat, sdofs, patch_cells)


class PatchSet:
    """Static patch topology for a VECTOR space, ready for device use.

    Attributes (numpy, converted lazily by the solver):
    dofs     (np, m)   flattened global vector-dof ids, pad = ndof_flat
    cells    (np, mc)  adjacent cells, pad = nc (dump tensor row)
    l2p      (np, mc, nld) cell-local flat dof -> patch-local, pad = m
    active   (np, m)   bool, True for real (non-pad) patch slots
    """

    def __init__(self, space, mask_flat, sdofs, pcells):
        d = space.value_size
        sdofs = np.asarray(sdofs, dtype=np.int64)
        pcells = np.asarray(pcells, dtype=np.int64)
        npat = sdofs.shape[0]
        # scalar -> vector dofs, drop constrained (mask==0) ones
        vd = np.where(sdofs[:, :, None] >= 0,
                      sdofs[:, :, None] * d + np.arange(d)[None, None, :],
                      -1).reshape(npat, -1)
        keep = (vd >= 0) & (mask_flat[np.clip(vd, 0, None)] > 0.5)
        vd = np.where(keep, vd, np.int64(np.iinfo(np.int64).max))
        vd.sort(axis=1)
        sizes_v = keep.sum(axis=1)
        m = int(sizes_v.max()) if npat else 0
        ndft = space.ndof * d
        # replace the huge sort sentinel with ndft so downstream int
        # arithmetic (stride offsets in _rowwise_member_index) can't
        # overflow; ndft is still larger than any real flat dof id
        vd = np.minimum(vd[:, :m], ndft)
        self.nflat = ndft
        self.m = m
        self.npatches = npat

        # cell-local flat dofs -> patch-local indices
        nc = space.mesh.num_cells
        nloc = space.cell_dofs.shape[1]
        cd = space.cell_dofs.astype(np.int64)
        cells_safe = np.clip(pcells, 0, nc - 1)
        local_flat = (cd[cells_safe][:, :, :, None] * d
                      + np.arange(d)[None, None, None, :]).reshape(
                          npat, pcells.shape[1], nloc * d)
        l2p = _rowwise_member_index(vd, local_flat, dump=m)
        # dead cell slots -> everything to dump row
        dead = pcells < 0
        l2p[dead] = m

        self.sizes = sizes_v
        self.active = np.arange(m)[None, :] < sizes_v[:, None]
        self.dofs = np.where(self.active, vd, ndft).astype(np.int64)
        self.cells = np.where(dead, nc, pcells).astype(np.int64)
        self.l2p = l2p.astype(index_dtype)
        #: vector size, for the d-row gather/scatter (_gather_scatter)
        self.space_d = d


def _merge_scalar_dofs(sdofs, sizes, extra):
    """Union per-row extra scalar dofs (np, k) into the padded lists;
    also dedups (``sizes`` is recomputed and may be None)."""
    merged = np.concatenate([sdofs, extra], axis=1)
    merged = np.where(merged >= 0, merged, np.int64(np.iinfo(np.int64).max))
    merged.sort(axis=1)
    # dedup per row
    dup = np.zeros_like(merged, dtype=bool)
    dup[:, 1:] = merged[:, 1:] == merged[:, :-1]
    merged = np.where(dup, np.int64(np.iinfo(np.int64).max), merged)
    merged.sort(axis=1)
    valid = merged < np.int64(np.iinfo(np.int64).max)
    sizes = valid.sum(axis=1)
    m = int(sizes.max())
    out = np.where(valid, merged, -1)[:, :m]
    return out, sizes


# ----------------------------------------------------------------------
# device half
# ----------------------------------------------------------------------
def contract_patch_tensors(patchset, tensors):
    """(np, m, m) patch operators summed from per-cell element tensors
    (NO padding diagonal — see assemble_patch_matrices):
    A_p = sum_j P_j^T T_j P_j with P_j the 0/1 cell-local -> patch-local
    placement, as one scatter-add (the JAX package's CPU formulation)."""
    m = patchset.m
    m1 = m + 1
    dev = tensors.device
    cells = torch.as_tensor(patchset.cells, device=dev)  # pad = nc
    l2p = torch.as_tensor(patchset.l2p, dtype=torch.int64, device=dev)
    npat = cells.shape[0]
    Tpad = torch.cat([tensors, tensors.new_zeros((1,) + tensors.shape[1:])])
    base = torch.arange(npat, device=dev)[:, None, None, None] * (m1 * m1)
    flat = base + l2p[:, :, :, None] * m1 + l2p[:, :, None, :]
    A = torch.zeros((npat * m1 * m1,), dtype=tensors.dtype, device=dev)
    A = A.index_add(0, flat.reshape(-1), Tpad[cells].reshape(-1))
    return A.reshape(npat, m1, m1)[:, :m, :m]


def patch_padding_diag(patchset, dtype, device):
    """(np, m) diagonal of the padding identity — 1.0 on padding slots,
    0.0 on active ones, so factorisations of padded patch matrices stay
    nonsingular."""
    active = torch.as_tensor(patchset.active, device=device)
    return torch.where(active, 0.0, 1.0).to(dtype)


def _add_diag(A, diag):
    ar = torch.arange(A.shape[-1], device=A.device)
    A = A.clone()
    A[:, ar, ar] += diag
    return A


def assemble_patch_matrices(patchset, tensors):
    """(np, m, m) patch operators summed from per-cell element tensors
    (unit diagonal on padding slots)."""
    return _add_diag(contract_patch_tensors(patchset, tensors),
                     patch_padding_diag(patchset, tensors.dtype,
                                        tensors.device))


def patch_static_operators(patchset, form):
    """One-time (per level) patch contraction of the geometry-only
    Jacobian parts: {"K": viscous, "G": grad-div, "pad_diag"}.  The
    per-Newton-step patch matrix is then

        A_p(params, wind) = nu K_p + gamma G_p + advect N_p(wind) + pad

    with only the advection part N contracted in the Newton loop (see
    make_patch_factor_parts)."""
    K_el, G_el = form._static_velocity_tensors()
    return {
        "K": contract_patch_tensors(patchset, K_el),
        "G": contract_patch_tensors(patchset, G_el),
        "pad_diag": patch_padding_diag(patchset, K_el.dtype, K_el.device),
    }


def make_patch_factor_parts(patchset):
    """factor_parts(static, N_el, params) -> explicit f64 inverses of
    nu K_p + gamma G_p + advect N_p + pad."""

    def factor_parts(static, N_el, params):
        A = _add_diag(params["nu"] * static["K"]
                      + params["gamma"] * static["G"], static["pad_diag"])
        if N_el is not None:
            A = A + params["advect"] * contract_patch_tensors(patchset,
                                                              N_el)
        return patch_inverses(A).contiguous()

    return factor_parts


def build_patch_solver(patchset, *, device):
    """Device operators over a PatchSet:

    factor(tensors (nc, nld, nld)) -> (np, m, m) explicit patch inverses
    apply(inv, r_flat (ndft,))     -> additive-Schwarz application,
                                      sum_p R_p^T inv_p R_p r (kernel K1;
                                      a GatherGemvScatter on the patch
                                      dof table)
    """

    def factor(tensors):
        return patch_inverses(assemble_patch_matrices(patchset,
                                                      tensors)).contiguous()

    return factor, GatherGemvScatter(patchset.dofs, patchset.nflat, "K1",
                                     device=device)
