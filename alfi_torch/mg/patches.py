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
  alfi_torch/kernels.py), or multiplicatively: conflict-free colours
  swept in the relaxation direction, one K1 table per colour and a
  residual update between colours (PCPatch's multiplicative +
  symmetrise_sweep, alfi/solver.py:321-328).

Padding goes to dump slots (row m of an (m+1)-sized accumulator, flat dof
index ndof*d, which the kernels read as 0) so every shape is static.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import index_dtype, real_dtype
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
        #: device -> (cells, flat index) of contract_patch_tensors
        self._contract_cache = {}

    def permuted(self, order):
        """The same patches in the order ``order`` (a permutation of the
        patch indices): every per-patch table reordered, none shared."""
        ps = copy.copy(self)
        for name in ("dofs", "cells", "l2p", "active", "sizes"):
            setattr(ps, name, getattr(self, name)[order])
        if getattr(self, "seed_points", None) is not None:
            ps.seed_points = self.seed_points[order]
        ps._contract_cache = {}
        return ps


def patch_facet_tables(patchset, facets, space):
    """Host tables mapping interior-facet Jacobians into patch
    operators: for each patch, the facets with >=1 adjacent cell in the
    patch (only those can share dofs with it) and the facet union-dof
    -> patch-local map.

    Returns (pfacets (np, mfp) [pad -> nif], fl2p (np, mfp, 2*nld)
    [pad/absent -> m])."""
    d = space.value_size
    cd = space.cell_dofs.astype(np.int64)
    nif = facets.nif
    fcells = np.asarray(facets.cells)  # (nif, 2) global cells
    nc = space.mesh.num_cells
    # cell -> interior facets (CSR)
    keys = fcells.reshape(-1)
    vals = np.repeat(np.arange(nif, dtype=np.int64), 2)
    starts, fv = _csr_from_pairs(keys, vals, nc)
    npat, mc = patchset.cells.shape
    # vectorised (patch, facet) pair enumeration
    cp = np.asarray(patchset.cells).astype(np.int64).ravel()
    valid = (cp >= 0) & (cp < nc)
    cpv = np.where(valid, cp, 0)
    cnt = np.where(valid, starts[cpv + 1] - starts[cpv], 0)
    total = int(cnt.sum())
    base = np.repeat(starts[cpv], cnt)
    csum = np.cumsum(cnt) - cnt
    offs = np.arange(total, dtype=np.int64) - np.repeat(csum, cnt)
    fids = fv[base + offs]
    pids = np.repeat(np.repeat(np.arange(npat, dtype=np.int64), mc),
                     cnt)
    key = np.unique(pids * np.int64(nif + 1) + fids)
    pstarts, pvals = _csr_from_pairs(key // (nif + 1), key % (nif + 1),
                                     npat)
    pfacets, _ = _pad_csr(pstarts, pvals, nif)
    if pfacets.shape[1] == 0:
        pfacets = np.full((npat, 1), nif, dtype=np.int64)
    # facet union flat dofs (nif+1, 2*nld); the pad value must MISS in
    # the patch dof rows — nflat itself is the patch-row pad and would
    # false-match, mapping facet pads onto inactive patch slots
    nld = cd.shape[1] * d
    fdofs = np.full((nif + 1, 2 * nld), patchset.nflat + 1,
                    dtype=np.int64)
    for s in range(2):
        flat = (cd[fcells[:, s]][:, :, None] * d
                + np.arange(d)[None, None, :]).reshape(nif, nld)
        fdofs[:nif, s * nld:(s + 1) * nld] = flat
    queries = fdofs[pfacets]  # (np, mfp, 2nld)
    fl2p = _rowwise_member_index(patchset.dofs, queries, dump=patchset.m)
    return pfacets, fl2p.astype(index_dtype)


def direction_order(points, spec):
    """Lexicographic sweep order from a relaxation-direction spec like
    "0+:1-" (alfi/relaxation.py:88-108): sort by axis 0 ascending, then
    axis 1 descending."""
    keys = []
    for part in spec.split(":"):
        axis = int(part[:-1])
        sgn = 1.0 if part[-1] == "+" else -1.0
        keys.append(sgn * points[:, axis])
    return np.lexsort(tuple(reversed(keys)))


def color_patchset(patchset, direction=None):
    """Conflict-free coloring of a PatchSet (shared-dof graph), visited
    in the sweep direction so colors respect the downstream ordering.
    Returns (colors (np,), ncolors)."""
    from ..native import greedy_color

    dofs = patchset.dofs
    active = patchset.active
    counts = active.sum(axis=1)
    csr_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    csr_vals = dofs[active].astype(np.int64)
    order = None
    if direction is not None and getattr(patchset, "seed_points",
                                         None) is not None:
        order = direction_order(patchset.seed_points, direction)
    return greedy_color(csr_off, csr_vals, patchset.nflat, order=order)


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
def _contract_index(patchset, dev):
    """(cells (np, mc), flat (mc, np*nld*nld)) on ``dev``: the padded cell
    table and, per (cell slot, patch, i, j), the flat position of
    A_p[l2p[i], l2p[j]] in the (np, m+1, m+1) accumulator.  Static per
    PatchSet, so built once per device and kept (at the 3D scale row the
    fine star table's index is 2 GB; rebuilding it per Newton step and
    level was the larger part of the contraction)."""
    cache = patchset._contract_cache
    if dev not in cache:
        m1 = patchset.m + 1
        cells = torch.as_tensor(patchset.cells, device=dev)  # pad = nc
        l2p = torch.as_tensor(patchset.l2p, dtype=torch.int64, device=dev)
        base = torch.arange(cells.shape[0],
                            device=dev)[:, None, None, None] * (m1 * m1)
        flat = base + l2p[:, :, :, None] * m1 + l2p[:, :, None, :]
        cache[dev] = (cells, flat.transpose(0, 1).reshape(cells.shape[1],
                                                          -1))
    return cache[dev]


def contract_patch_tensors(patchset, tensors):
    """(np, m, m) patch operators summed from per-cell element tensors
    (NO padding diagonal — see assemble_patch_matrices):
    A_p = sum_j P_j^T T_j P_j with P_j the 0/1 cell-local -> patch-local
    placement, as one scatter-add per cell slot.  Within a slot no two
    live entries meet (only the dropped padding row and column collect
    several), so the card adds without colliding atomics and each entry
    sums its cells in slot order, as one sequential scatter-add (the JAX
    package's CPU formulation) does."""
    m = patchset.m
    m1 = m + 1
    cells, flat = _contract_index(patchset, tensors.device)
    npat = cells.shape[0]
    Tpad = torch.cat([tensors, tensors.new_zeros((1,) + tensors.shape[1:])])
    A = torch.zeros((npat * m1 * m1,), dtype=tensors.dtype,
                    device=tensors.device)
    for s in range(cells.shape[1]):
        A.index_add_(0, flat[s], Tpad[cells[:, s]].reshape(-1))
    return A.reshape(npat, m1, m1)[:, :m, :m]


def contract_patch_facet_tensors(ftabs, Jf):
    """(np, m, m) patch contributions from interior-facet Jacobians
    Jf (nif, 2nld, 2nld): the Burman coupling of the stabilised patch
    operators, one scatter-add per facet slot and block of sides
    (side 0 rows and side 0 columns, then 0 and 1, 1 and 0, 1 and 1) at
    each Newton-step set-up.  The two sides share the facet's dofs, so a
    facet block can add twice to one entry; one side's rows against one
    side's columns cannot, and the blocks in that order sum each entry
    as one sequential scatter-add over the whole table does, with no
    colliding atomics on the card.  ``ftabs``: the patch set's
    :class:`FacetPatchTables`."""
    pfacets, flat = ftabs.index(Jf.device)
    m = ftabs.m
    m1 = m + 1
    npat, nfs = pfacets.shape
    nld = Jf.shape[1] // 2
    Jpad = torch.cat([Jf, Jf.new_zeros((1,) + Jf.shape[1:])])
    Jpad = Jpad.reshape(-1, 2, nld, 2, nld)
    A = torch.zeros((npat * m1 * m1,), dtype=Jf.dtype, device=Jf.device)
    # the gathered facet blocks in patch chunks of at most 1 GB: the 3D
    # SV k=3 macrostar patches (ldc3d baseN=2 nref=1: 125 patches, m =
    # 1590) touch 246 facets of 120 x 120 each, 28 MB a patch and 3.5 GB
    # at once; the 80 GB card holds that, but the chunks keep the
    # set-up's peak at the inverse table's size (2.5 GB), not above it
    per = pfacets[0].numel() * Jf.shape[1] * Jf.shape[2]
    chunk = max(1, (1 << 30) // (8 * per))
    for c0 in range(0, npat, chunk):
        c1 = min(npat, c0 + chunk)
        for s in range(nfs):
            f = flat[c0:c1, s]
            J = Jpad[pfacets[c0:c1, s]]
            for a in range(2):
                for b in range(2):
                    A.index_add_(0, f[:, a, :, b, :].reshape(-1),
                                 J[:, a, :, b, :].reshape(-1))
    return A.reshape(npat, m1, m1)[:, :m, :m]


class FacetPatchTables:
    """:func:`patch_facet_tables` of one PatchSet, and per device the flat
    position of every (patch, facet slot, i, j) entry in the (np, m+1,
    m+1) accumulator, built on first use and kept (static topology, as
    :func:`_contract_index` keeps the cells')."""

    def __init__(self, patchset, facets, space):
        self.m = patchset.m
        self.pfacets, self.fl2p = patch_facet_tables(patchset, facets,
                                                     space)
        self._index = {}

    def index(self, dev):
        if dev not in self._index:
            m1 = self.m + 1
            pf = torch.as_tensor(self.pfacets, device=dev)
            l2p = torch.as_tensor(self.fl2p, dtype=torch.int64, device=dev)
            base = torch.arange(pf.shape[0],
                                device=dev)[:, None, None, None] * (m1 * m1)
            flat = base + l2p[:, :, :, None] * m1 + l2p[:, :, None, :]
            nld = flat.shape[-1] // 2
            self._index[dev] = (pf, flat.reshape(pf.shape + (2, nld, 2,
                                                             nld)))
        return self._index[dev]


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


def patch_static_operators(patchset, form, store=None):
    """One-time (per level) patch contraction of the geometry-only
    Jacobian parts: {"K": viscous, "G": grad-div, "pad_diag"}.  The
    per-Newton-step patch matrix is then

        A_p(params, wind) = nu K_p + gamma G_p + advect N_p(wind) + pad

    with only the advection part N contracted in the Newton loop (see
    make_patch_factor_parts).  K and G are kept in the storage dtype
    ``store`` (``config.mg_store``; None: the tensors' f64): in f32 they
    take half the memory, a consistent relative-eps32 perturbation of
    the operator, and :func:`static_patch_sum` promotes them back."""
    K_el, G_el = form._static_velocity_tensors()
    K = contract_patch_tensors(patchset, K_el)
    G = contract_patch_tensors(patchset, G_el)
    if store is not None and store != K.dtype:
        K, G = K.to(store), G.to(store)
    return {"K": K, "G": G,
            "pad_diag": patch_padding_diag(patchset, K_el.dtype, K_el.device)}


def static_patch_sum(static, params):
    """nu K_p + gamma G_p + pad in f64 from patch_static_operators' parts;
    f32-stored parts are promoted one at a time (in place on the f64
    copies, so that the peak holds two f64 tables, not five)."""
    K, G = static["K"], static["G"]
    if K.dtype == real_dtype:
        return _add_diag(params["nu"] * K + params["gamma"] * G,
                         static["pad_diag"])
    A = K.to(real_dtype).mul_(params["nu"])
    A.add_(G.to(real_dtype).mul_(params["gamma"]))
    ar = torch.arange(A.shape[-1], device=A.device)
    A[:, ar, ar] += static["pad_diag"]
    return A


def make_patch_factor_parts(patchset):
    """factor_parts(static, N_el, params) -> explicit f64 inverses of
    nu K_p + gamma G_p + advect N_p + pad (``invert=False``: the matrices
    themselves)."""

    def factor_parts(static, N_el, params, invert=True):
        A = static_patch_sum(static, params)
        if N_el is not None:
            A = A + params["advect"] * contract_patch_tensors(patchset,
                                                              N_el)
        return patch_inverses(A).contiguous() if invert else A

    return factor_parts


def build_patch_solver(patchset, *, out_mask=None, device):
    """Device operators over a PatchSet:

    factor(tensors (nc, nld, nld)) -> (np, m, m) explicit patch inverses
    apply(inv, r_flat (ndft,)[, passthrough])
                                   -> additive-Schwarz application,
                                      sum_p R_p^T inv_p R_p r (kernel K1;
                                      a GatherGemvScatter on the patch
                                      dof table, see alfi_torch/kernels.py)

    The table holds no dof that the PatchSet's mask drops, so the input
    needs no mask; an ``out_mask`` selects ``passthrough`` at its 0s.
    """

    return make_patch_factor(patchset), GatherGemvScatter(
        patchset.dofs, patchset.nflat, "K1", out_mask=out_mask,
        device=device)


def make_patch_factor(patchset):
    """factor(tensors (nc, nld, nld)) -> (np, m, m) explicit inverses of
    the patch matrices summed from the whole cell tensors
    (``invert=False``: the matrices themselves)."""

    def factor(tensors, invert=True):
        A = assemble_patch_matrices(patchset, tensors)
        return patch_inverses(A).contiguous() if invert else A

    return factor


class MultiplicativeSweep:
    """The ordered multiplicative patch sweep of one PatchSet, as a
    sequence of conflict-free additive sub-sweeps (one per colour) with
    residual updates between them (the JAX package's
    ``build_multiplicative_solver``).

    ``patchset`` holds the patches in colour order (colour c is the
    slice ``bounds[c]:bounds[c+1]``), so the inverses that
    :func:`build_patch_solver`'s factor returns for it per Newton step
    hold each colour as a contiguous view: no gather of the inverse
    table per step.  Each colour has its own K1 table
    (:class:`GatherGemvScatter`); no two patches of a colour share a dof,
    so each dof's CSR list holds at most one slot."""

    def __init__(self, patchset, bounds, *, device):
        self.patchset = patchset
        self.bounds = [int(b) for b in bounds]
        ncolors = len(self.bounds) - 1
        self.ncolors = ncolors
        #: per colour its K1 table
        self.tables = [
            GatherGemvScatter(patchset.dofs[self.bounds[c]:
                                            self.bounds[c + 1]],
                              patchset.nflat, "K1", device=device)
            for c in range(ncolors)]
        seq = list(range(ncolors))
        #: the colours in sweep order: forth, then back (symmetrised, as
        #: PCPatch's symmetrise_sweep, alfi/solver.py:321-328)
        self.seq = seq + seq[::-1]

    def __call__(self, inv, b, Aop):
        """The sweep from a zero initial guess: for each colour c of
        ``seq``, r = b - Aop(x) (r = b for the first) and x += K1_c(r),
        with K1_c the colour's patch inverses ``inv[bounds[c]:
        bounds[c+1]]``.  ``b``, ``Aop`` flat; returns x flat, zero on
        the dofs no patch holds."""
        x = None
        for c in self.seq:
            r = b if x is None else b - Aop(x)
            y = self.tables[c](inv[self.bounds[c]:self.bounds[c + 1]], r)
            x = y if x is None else x + y
        return x


def build_multiplicative_solver(patchset, direction=None, *, device):
    """Ordered multiplicative patch sweep (PCPatch's multiplicative +
    symmetrise_sweep, alfi/solver.py:321-328) over ``patchset``,
    coloured conflict-free in the relaxation ``direction``.

    Returns (ordered, factor, apply): ``ordered`` the PatchSet permuted
    into colour order once on the host, ``factor(tensors)`` its explicit
    patch inverses (build_patch_solver's), ``apply(inv, b_flat,
    Aop_flat)`` the sweep (:class:`MultiplicativeSweep`)."""
    colors, ncolors = color_patchset(patchset, direction)
    order = np.argsort(colors, kind="stable")
    bounds = np.searchsorted(colors[order], np.arange(ncolors + 1))
    ordered = patchset.permuted(order)
    return ordered, make_patch_factor(ordered), MultiplicativeSweep(
        ordered, bounds, device=device)
