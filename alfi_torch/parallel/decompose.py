"""Host-side domain decomposition compiler for the distributed almg solver.

A numpy copy of the JAX package's ``parallel/decompose.py``: the tables
must equal its tables exactly (tests/test_torch_decompose.py).

The reference's parallel story is DMPlex mesh partitioning with ghost
overlap (vertex-overlap 1 for PkP0, 2 for SV,
alfi/solver.py:604-605,661-662), refined per MG level, with
VecScatter halo exchange and allreduce dots.  The formulation built here:

* partition the COARSEST mesh's cells into ``nb`` contiguous blocks
  (centroid lexsort), take a 2-cell-layer overlap, and REFINE the
  partitions through the hierarchy (children inherit the parent's block) —
  so every level's block-local cell set is exactly the refinement of the
  coarse subdomain + halo shell, and all transfers/patches stay
  block-local by lineage;
* per level, compile the local scalar-dof table of each block, the unique
  dof owner (block of the smallest-index cell containing the dof), and
  the interface-exchange tables (local index, shared slot) whose sum over
  the ranks completes any owned-cells-only scatter;
* localize the star-patch sets, the Schoeberl coarse-cell patch sets and
  the nodal transfers into block-local index arrays (padded identically
  across blocks).

Everything here is numpy on the host, and every rank computes the same
tables from the same host hierarchy; rank b's device arrays are row b of
them (``alfi_torch/parallel/distributed.py``).
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------------
# mesh partition helpers
# ----------------------------------------------------------------------
def vertex_cells_csr(mesh):
    """CSR vertex -> containing cells (cached on the mesh: callers like
    expand_halo run once per block per level, and the argsort over all
    cells dominated decomposition setup)."""
    cached = getattr(mesh, "_vcells_csr", None)
    if cached is not None:
        return cached
    from ..mg.patches import _csr_from_pairs

    cells = mesh.cells
    nv = mesh.num_vertices
    ck = cells.ravel().astype(np.int64)
    cv = np.repeat(np.arange(mesh.num_cells, dtype=np.int64),
                   cells.shape[1])
    starts, cv = _csr_from_pairs(ck, cv, nv)
    mesh._vcells_csr = (starts, cv)
    return mesh._vcells_csr


def expand_halo(mesh, cellmask, layers=1):
    """Grow a boolean cell set by vertex-adjacency layers."""
    starts, cv = vertex_cells_csr(mesh)
    nv = mesh.num_vertices
    vk = np.repeat(np.arange(nv, dtype=np.int64), np.diff(starts))
    out = cellmask.copy()
    for _ in range(layers):
        vm = np.zeros(nv, dtype=bool)
        vm[mesh.cells[out].ravel()] = True
        adj = np.bincount(cv[vm[vk]],
                          minlength=mesh.num_cells).astype(bool)
        out = out | adj
    return out


def coarse_partition(mesh, nb):
    """(nc,) block id per cell: centroid-lexsorted contiguous chunks (the
    locality-ordered analogue of a DMPlex partitioner)."""
    cent = mesh.vertices[mesh.cells].mean(axis=1)
    order = np.lexsort(tuple(cent[:, ax]
                             for ax in range(mesh.dim - 1, -1, -1)))
    nc = mesh.num_cells
    block = np.empty(nc, dtype=np.int64)
    sizes = np.full(nb, nc // nb, dtype=np.int64)
    sizes[: nc % nb] += 1
    stops = np.concatenate([[0], np.cumsum(sizes)])
    for b in range(nb):
        block[order[stops[b]:stops[b + 1]]] = b
    return block


def rcb_partition(mesh, nb):
    """Recursive coordinate bisection of cell centroids — the
    ``--rebalance`` partitioner (the reference's
    dm.rebalanceSharedPoints quality-improvement analogue,
    alfi/solver.py:86-99): at each split the cell set
    is halved by the median along its widest axis, which bounds both
    the count imbalance (exact halving) and the interface surface on
    anisotropic/unstructured meshes where lexsorted chunks degenerate
    into slivers."""
    cent = mesh.vertices[mesh.cells].mean(axis=1)
    nc = mesh.num_cells
    block = np.zeros(nc, dtype=np.int64)

    def split(idx, b0, n):
        if n == 1:
            block[idx] = b0
            return
        nl = n // 2
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, ax], kind="stable")
        cut = len(idx) * nl // n
        split(idx[order[:cut]], b0, nl)
        split(idx[order[cut:]], b0 + nl, n - nl)

    split(np.arange(nc, dtype=np.int64), 0, nb)
    return block


def propagate_blocks(hierarchy, block0_uniform):
    """Per-level cell block ids by lineage (children inherit the parent's
    block).  For a bary hierarchy the partition lives on the uniform
    chain; bary cells take their uniform parent's block.  Returns
    (blocks_per_level, uniform_blocks_per_level)."""
    nlev = len(hierarchy)
    if hierarchy.kind == "bary":
        ub = [block0_uniform]
        for l in range(1, nlev):
            u = hierarchy.uniform_meshes[l]
            ub.append(ub[l - 1][u.parent_cell])
        blocks = [ub[l][hierarchy[l].parent_cell] for l in range(nlev)]
        return blocks, ub
    blocks = [block0_uniform]
    for l in range(1, nlev):
        blocks.append(blocks[l - 1][hierarchy[l].parent_cell])
    return blocks, blocks


def _pad_rows_list(rows, fill):
    n = max((len(r) for r in rows), default=0)
    out = np.full((len(rows), n), fill, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


# ----------------------------------------------------------------------
# per-level decomposition
# ----------------------------------------------------------------------
class LevelDecomp:
    """Block-local dof/cell tables of one MG level's velocity space.

    Layout per block (identical static shapes across blocks):
    * cells_pad (nb, mc): global cell ids, OWNED slots first ([:mco]),
      halo after, dead = -1;
    * gdofs (nb, L): sorted global scalar dofs of the live cells, pad -1;
      local state arrays are (L+1, d) with a zero dump row L;
    * lcd (nb, mc, nloc): cell dofs in local indices (dead cell -> L);
    * owner (nb, L): True where this block owns the dof (dof owner =
      block of the smallest global cell containing it);
    * lidx/sslot (nb, ms): interface-exchange tables — psum a packed
      (ns+1, d) buffer over the mesh axis to complete a scatter.
    """

    def __init__(self, V, owned_cells, halo_cells, cell_block):
        self.V = V
        nb = len(owned_cells)
        self.nb = nb
        cd = V.cell_dofs.astype(np.int64)
        nloc = cd.shape[1]
        ndof = V.ndof
        self.d = V.value_size

        mco = max(len(o) for o in owned_cells)
        mch = max(len(h) for h in halo_cells)
        self.mco, self.mch = mco, mch
        mc = mco + mch
        self.mc = mc
        cells_pad = np.full((nb, mc), -1, dtype=np.int64)
        for b in range(nb):
            cells_pad[b, : len(owned_cells[b])] = owned_cells[b]
            cells_pad[b, mco: mco + len(halo_cells[b])] = halo_cells[b]
        self.cells_pad = cells_pad
        self.dead = cells_pad < 0
        self.owned_cell = np.zeros((nb, mc), dtype=bool)
        self.owned_cell[:, :mco] = cells_pad[:, :mco] >= 0

        # dof owner block: block of the smallest cell containing the dof
        owner_cell = np.full(ndof, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(owner_cell, cd.ravel(),
                      np.repeat(np.arange(V.mesh.num_cells,
                                          dtype=np.int64), nloc))
        assert owner_cell.max() < np.iinfo(np.int64).max
        dof_block = cell_block[owner_cell]
        self.dof_block = dof_block

        # local dof tables
        gdofs_l, g2l = [], []
        for b in range(nb):
            live = cells_pad[b][cells_pad[b] >= 0]
            gd = np.unique(cd[live])
            gdofs_l.append(gd)
            lut = np.full(ndof, -1, dtype=np.int64)
            lut[gd] = np.arange(len(gd))
            g2l.append(lut)
        L = max(len(g) for g in gdofs_l)
        self.L = L
        self.gdofs = _pad_rows_list(gdofs_l, -1)
        self.valid = self.gdofs >= 0
        self.g2l = g2l  # host-only lookup tables

        # every block must contain the dofs it owns
        for b in range(nb):
            owned_dofs = np.where(dof_block == b)[0]
            assert np.all(g2l[b][owned_dofs] >= 0), (
                f"block {b} missing owned dofs")

        lcd = np.full((nb, mc, nloc), L, dtype=np.int64)
        for b in range(nb):
            live = cells_pad[b] >= 0
            lcd[b, live] = g2l[b][cd[cells_pad[b][live]]]
        self.lcd = lcd

        self.owner = (dof_block[np.clip(self.gdofs, 0, None)]
                      == np.arange(nb)[:, None]) & self.valid

        # interface-exchange tables: dofs present in >= 2 blocks
        counts = np.zeros(ndof, dtype=np.int64)
        for b in range(nb):
            counts[gdofs_l[b]] += 1
        shared = np.where(counts >= 2)[0]
        ns = len(shared)
        self.ns = ns
        slot = np.full(ndof, -1, dtype=np.int64)
        slot[shared] = np.arange(ns)
        lidx_l, sslot_l = [], []
        for b in range(nb):
            sl = slot[gdofs_l[b]]
            ii = np.where(sl >= 0)[0]
            lidx_l.append(ii)
            sslot_l.append(sl[ii])
        self.lidx = _pad_rows_list(lidx_l, L)      # pad -> dump row
        self.sslot = _pad_rows_list(sslot_l, ns)   # pad -> dump slot

    def localize_scalar_dofs(self, dofs_global, dump=None):
        """(nb, ...) global scalar-dof arrays -> local indices (missing
        or pad -> dump, default the dump row L)."""
        if dump is None:
            dump = self.L
        out = np.full((self.nb,) + dofs_global.shape[1:], dump,
                      dtype=np.int64)
        for b in range(self.nb):
            g = dofs_global[b]
            ok = g >= 0
            loc = self.g2l[b][np.clip(g, 0, None)]
            out[b] = np.where(ok & (loc >= 0), loc, dump)
        return out

    def localize_cells(self, cells_global):
        """Global cell id arrays (shared across blocks) -> per-block local
        cell slots (missing -> mc)."""
        nb, mc = self.nb, self.mc
        ncells = self.V.mesh.num_cells
        out = np.full((nb,) + cells_global.shape, mc, dtype=np.int64)
        for b in range(nb):
            c2l = np.full(ncells, mc, dtype=np.int64)
            live = self.cells_pad[b] >= 0
            c2l[self.cells_pad[b][live]] = np.where(live)[0]
            ok = cells_global >= 0
            out[b] = np.where(ok, c2l[np.clip(cells_global, 0, None)], mc)
        return out

    def near_owned_dofs(self, mesh, layers=1):
        """Global scalar dofs of cells within ``layers`` vertex-adjacency
        layers of each block's owned cells (the region where localized
        operators MUST be exact)."""
        cd = self.V.cell_dofs.astype(np.int64)
        res = []
        for b in range(self.nb):
            m = np.zeros(mesh.num_cells, dtype=bool)
            live = self.cells_pad[b, : self.mco]
            m[live[live >= 0]] = True
            m = expand_halo(mesh, m, layers)
            res.append(np.unique(cd[m]))
        return res


# ----------------------------------------------------------------------
# patch-set / transfer localization
# ----------------------------------------------------------------------
def split_patchset(ps, patch_block, lev: LevelDecomp):
    """Slice a global PatchSet by owning block and remap to local indices.

    Returns dict of per-block padded arrays:
      pdofs (nb, npm, m) local FLAT dof ids (pad -> dump flat L*d),
      pcells (nb, npm, mcp) local cell slots (pad -> mc),
      pl2p (nb, npm, mcp, nld) cell-local -> patch-local (pad -> m),
      pactive (nb, npm, m) real-slot mask.
    """
    nb, L, mc, d = lev.nb, lev.L, lev.mc, lev.d
    dumpf = L * d
    m = ps.m
    pids = [np.where(patch_block == b)[0] for b in range(nb)]
    npm = max(len(p) for p in pids)

    pdofs = np.full((nb, npm, m), dumpf, dtype=np.int64)
    pcells = np.full((nb, npm) + ps.cells.shape[1:], mc, dtype=np.int64)
    pl2p = np.full((nb, npm) + ps.l2p.shape[1:], m, dtype=np.int64)
    pactive = np.zeros((nb, npm, m), dtype=bool)
    ncells = lev.V.mesh.num_cells
    for b in range(nb):
        sel = pids[b]
        n = len(sel)
        if n == 0:
            continue
        dofs = ps.dofs[sel]  # global flat, pad = ps.nflat
        scal = dofs // d
        comp = dofs % d
        real = dofs < ps.nflat
        ndof_s = lev.g2l[b].shape[0]
        loc = lev.g2l[b][np.clip(scal, 0, ndof_s - 1)]
        assert np.all(loc[real] >= 0), (
            f"patch dofs missing from block {b} table")
        pdofs[b, :n] = np.where(real, loc * d + comp, dumpf)
        cells = ps.cells[sel]  # pad = ncells
        c2l = np.full(ncells + 1, mc, dtype=np.int64)
        live = lev.cells_pad[b] >= 0
        c2l[lev.cells_pad[b][live]] = np.where(live)[0]
        lc = c2l[np.clip(cells, 0, ncells)]
        assert np.all(lc[cells < ncells] < mc), (
            f"patch cells missing from block {b} table")
        pcells[b, :n] = lc
        pl2p[b, :n] = ps.l2p[sel]
        pactive[b, :n] = ps.active[sel]
    return dict(pdofs=pdofs, pcells=pcells, pl2p=pl2p, pactive=pactive,
                m=m, npm=npm)


def split_transfer(idx_g, w_g, src_lev: LevelDecomp, tgt_lev: LevelDecomp,
                   must_resolve):
    """Localize a PointEvalTransfer (target dof <- weighted source dofs).

    idx_g (ndof_t, ns) global SOURCE scalar dofs; w_g (ndof_t, ns) for
    scalar weights or (ndof_t, ns, d, d) for matrix weights (the
    BubbleTransfer flux fix mixes vector components per source dof).
    Rows are built for every local TARGET dof of every block; rows whose
    source dofs are not all present locally become dead (zero weights) —
    allowed only outside ``must_resolve[b]`` (asserted).

    Returns (idx_loc (nb, Lt, ns) [pad -> src dump row], w_loc).
    """
    nb, Lt = tgt_lev.nb, tgt_lev.L
    ns = idx_g.shape[1]
    Ls = src_lev.L
    idx_loc = np.full((nb, Lt, ns), Ls, dtype=np.int64)
    w_loc = np.zeros((nb, Lt, ns) + w_g.shape[2:], dtype=w_g.dtype)
    for b in range(nb):
        gt = tgt_lev.gdofs[b]
        validt = gt >= 0
        ig = idx_g[np.clip(gt, 0, None)]  # (Lt, ns)
        loc = src_lev.g2l[b][ig]
        ok = validt & np.all(loc >= 0, axis=1)
        if must_resolve is not None:
            need = np.zeros(Lt, dtype=bool)
            lutn = np.isin(gt, must_resolve[b])
            need |= lutn & validt
            assert np.all(ok[need]), (
                f"transfer rows unresolvable near owned region, block {b}")
        idx_loc[b][ok] = loc[ok]
        w_loc[b][ok] = w_g[np.clip(gt, 0, None)][ok]
    return idx_loc, w_loc
