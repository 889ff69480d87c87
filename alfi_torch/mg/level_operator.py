"""The merged level operator's host tables (numpy, built once per level).

The level operator of the almg cycle is

    A v = mask * (sum_c R_c^T T_c R_c + sum_f R_f^T F_f R_f) (mask * v)
          + (1 - mask) * v

with per-cell element tensors T_c (nc, nld, nld) and, with Burman's
stabilisation, per-interior-facet Jacobians F_f (nf, 2 nld, 2 nld), both
rebuilt once per Newton step.  The blocks repeat each coupling many
times (a dof of a facet block stands in every facet of every cell around
it), so the cycle applies the SUMMED operator: once per level and Newton
step the blocks are added into one operator of distinct couplings (kernel
KA, the assembly), which every apply of that step reads (kernel KM);
``alfi_torch/kernels.py:MergedLevelOperator`` binds both.

This module builds what is static per level: the operator's pattern, as
node-pair d x d blocks (BSR; every row of ``vector_rows`` holds every
component of its node, so the couplings always come in whole blocks), and
the assembly map, which fixes each merged entry's sources and the order
they are summed in.  The BC masks are folded in: an entry whose row or
column is masked has no source and stays 0, and a block with no live entry
is not stored, so a node whose components are all masked has an empty
row and takes the passthrough.
"""

from __future__ import annotations

import time

import numpy as np

#: the kernels' int32 indices hold positions below this
INT32_LIMIT = 2 ** 31


def node_blocks(rows, d):
    """(nb, nl) node ids of a flat-row table whose rows are whole node
    blocks (flat dof = node * d + component, components ascending within
    a node, as ``vector_rows`` builds them); raises otherwise."""
    rows = np.asarray(rows, dtype=np.int64)
    nb, m = rows.shape
    if m % d:
        raise ValueError("a row of %d dofs is not whole %d-dof node blocks"
                         % (m, d))
    blocks = rows.reshape(nb, m // d, d)
    nodes = blocks[:, :, 0] // d
    if not np.array_equal(blocks, nodes[:, :, None] * d + np.arange(d)):
        raise ValueError("the table's rows are not whole node blocks "
                         "(flat dof = node * d + component)")
    return nodes


class LevelPattern:
    """The merged operator's pattern and assembly map for one level.

    ``rows`` (nc, nld) and ``frows`` (nf, 2 nld) or None: the flat-dof
    tables of the cell and facet blocks; ``keep`` (n,): the level's 0/1
    BC mask (1 = live) of the n = nodes * d flat dofs.

    * ``rowptr`` (nodes + 1,), ``bcol`` (nnzb,): BSR over nodes, block
      columns ascending within each row; block b holds the d x d
      couplings (row node, bcol[b]) at merged entries b*d*d + i*d + j
      (component i of the row node, j of the column node);
    * ``amap_ptr`` (nnzb*d*d + 1,), ``amap_src`` (nlive,): the assembly
      map, a dest-major CSR of source positions in [cell tensors flat ‖
      facet tensors flat] (a position p >= ``ncell`` is entry p - ncell of
      the facet tensors).  A merged entry's sources are its live block
      entries, cells first, then facets, each ascending: the order KA sums
      them in;
    * ``nsource``: every block entry, cells and facets, masked included;
      ``nlive``: the live ones; ``seconds``: the host time of the build.

    Index arrays are int32; raises if an index would reach 2**31.
    """

    def __init__(self, rows, n, d, keep, frows=None):
        t0 = time.perf_counter()
        n, d = int(n), int(d)
        keep = np.asarray(keep, dtype=np.float64).reshape(-1)
        if keep.shape != (n,) or n % d:
            raise ValueError("keep has %d values, the level %d of %d "
                             "components" % (keep.size, n, d))
        if not np.all((keep == 0.0) | (keep == 1.0)):
            raise ValueError("keep must hold only 0 and 1")
        keep = keep == 1.0
        tables = [rows] if frows is None else [rows, frows]
        nodes = [node_blocks(t, d) for t in tables]
        self.n, self.d, self.nodes = n, d, n // d
        shapes = [(t.shape[0], t.shape[1] * d, t.shape[1] * d)
                  for t in nodes]
        #: the cell and facet tensors' shapes (None without facets)
        self.cell_shape = shapes[0]
        self.facet_shape = shapes[1] if frows is not None else None
        sizes = [int(np.prod(s)) for s in shapes]
        self.ncell, self.nsource = sizes[0], sum(sizes)
        if self.nsource >= INT32_LIMIT:
            raise ValueError("level too large for int32 assembly indices")
        nn = self.nodes
        keep_nodes = keep.reshape(nn, d)

        # per source block (a node pair (a, b) of one cell or facet c):
        # its key, its live entries, and the position of its entry (0, 0);
        # entry (i, j) sits at base + i * (row length) + j
        keys, lives, bases, strides = [], [], [], []
        offset = 0
        for nod, size in zip(nodes, sizes):
            nb, nl = nod.shape
            kn = keep_nodes[nod]  # (nb, nl, d)
            keys.append((nod[:, :, None] * nn + nod[:, None, :]).reshape(-1))
            lives.append((kn[:, :, None, :, None]
                          & kn[:, None, :, None, :]).reshape(-1, d * d))
            ab = np.arange(nl)
            bases.append((offset + (np.arange(nb)[:, None, None] * nl
                                    + ab[None, :, None]) * (d * nl * d)
                          + ab[None, None, :] * d).reshape(-1))
            strides.append(np.full(nb * nl * nl, nl * d))
            offset += size
        key, live, base, stride = (np.concatenate(a) for a in
                                   (keys, lives, bases, strides))
        del keys, lives, bases, strides
        used = live.any(axis=1)
        key, live, base, stride = key[used], live[used], base[used], \
            stride[used]
        self.nlive = int(live.sum())

        blocks, inv = np.unique(key, return_inverse=True)
        inv = inv.reshape(-1)
        nnzb = len(blocks)
        if nnzb * d * d >= INT32_LIMIT:
            raise ValueError("level too large for int32 merged entries")
        self.nnzb = nnzb
        self.bcol = (blocks % nn).astype(np.int32)
        self.rowptr = np.searchsorted(blocks // nn,
                                      np.arange(nn + 1)).astype(np.int32)

        # the assembly map, dest-major: each merged block's source blocks
        # in ascending position (a stable sort of the concatenation, cells
        # first), laid out entry by entry, then the masked entries dropped
        order = np.argsort(inv, kind="stable")
        inv, live, base, stride = inv[order], live[order], base[order], \
            stride[order]
        per_block = np.bincount(inv, minlength=nnzb)
        first = np.concatenate([[0], np.cumsum(per_block)])[inv]
        rank = np.arange(len(inv)) - first
        ij = np.arange(d * d)
        slot = (first[:, None] * (d * d) + ij[None, :] * per_block[inv][:, None]
                + rank[:, None]).reshape(-1)
        pos = (base[:, None] + (ij // d)[None, :] * stride[:, None]
               + (ij % d)[None, :]).reshape(-1)
        src = np.empty(len(slot), dtype=np.int64)
        src_live = np.empty(len(slot), dtype=bool)
        src[slot], src_live[slot] = pos, live.reshape(-1)
        del slot, pos
        self.amap_src = src[src_live].astype(np.int32)
        counts = np.bincount((inv[:, None] * (d * d) + ij[None, :])[live],
                             minlength=nnzb * d * d)
        self.amap_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int32)
        self.keep = keep
        self.seconds = time.perf_counter() - t0

    @property
    def row_lengths(self):
        """(nodes,) blocks per node row."""
        return np.diff(self.rowptr)

    @property
    def merge_factor(self):
        """Block entries (cells and facets) over merged entries."""
        return self.nsource / max(self.nnzb * self.d * self.d, 1)
