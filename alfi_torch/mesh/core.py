"""Simplicial mesh core (host-side, numpy).

TPU-native replacement for the DMPlex layer the reference depends on
(alfi/bary.py, alfi/relaxation.py rely on DMPlex topology
queries).  All topology is computed once on the host as flat numpy arrays;
the device only ever sees padded integer maps derived from these.

Conventions
-----------
* cells are (nc, d+1) vertex indices, positively oriented (det of edge
  matrix > 0).
* local facet ``i`` of a cell is opposite local vertex ``i`` (the facet's
  vertices are the cell's vertices with entry ``i`` removed, in order).
* ``facet_markers`` holds boundary tags; the rectangle/box generators use
  the Firedrake numbering (1: x=0, 2: x=Lx, 3: y=0, 4: y=Ly, 5: z=0,
  6: z=Lz) so the problem definitions keep the reference's BC ids
  (e.g. examples/ldc2d/ldc2d.py:22-24).
* ``facet_birth_level`` replaces the reference's "prolongation" DMPlex
  label (alfi/solver.py:101-107): the hierarchy level at
  which a facet (or its geometric ancestor) first appeared.  A facet of
  the level-``l`` mesh lies on the level-``l-1`` (or coarser) skeleton iff
  ``birth <= l - 1``.
"""

from __future__ import annotations

import numpy as np

from ..config import index_dtype


def _sorted_rows(a):
    return np.sort(a, axis=1)


def _row_unique_inverse(rows):
    """Unique rows + inverse map (rows must be sorted per-row); uses the
    native C++ dedup when available (alfi_tpu/native/topology.cpp)."""
    from ..native import sorted_row_dedup

    uniq, inverse = sorted_row_dedup(rows)
    return uniq, inverse.astype(index_dtype)


def _row_view(a):
    a = np.ascontiguousarray(np.asarray(a, dtype=np.int64))
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


def match_rows(table, queries):
    """Indices into ``table`` of each row of ``queries``.

    Rows must be per-row sorted.  Raises if a query row is missing.
    """
    tv = _row_view(table)
    qv = _row_view(queries)
    order = np.argsort(tv)
    pos = np.searchsorted(tv[order], qv)
    idx = order[np.clip(pos, 0, len(tv) - 1)]
    if not np.all(tv[idx] == qv):
        raise KeyError("query rows not found in table")
    return idx.astype(index_dtype)


def orient_cells(vertices, cells):
    """Return cells re-ordered so every simplex has positive volume."""
    cells = np.asarray(cells, dtype=index_dtype).copy()
    v = vertices[cells]  # (nc, d+1, d)
    edges = v[:, 1:, :] - v[:, :1, :]  # (nc, d, d)
    det = np.linalg.det(edges)
    flip = det < 0
    if np.any(flip):
        cells[flip, -2], cells[flip, -1] = (
            cells[flip, -1].copy(),
            cells[flip, -2].copy(),
        )
    return cells


class Mesh:
    """An unstructured simplicial mesh (triangles in 2D, tets in 3D)."""

    def __init__(self, vertices, cells, facet_markers_from=None, name="mesh"):
        self.name = name
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float64)
        self.dim = self.vertices.shape[1]
        self.cells = orient_cells(self.vertices, cells)
        self.num_vertices = self.vertices.shape[0]
        self.num_cells = self.cells.shape[0]
        self._build_facets()
        # boundary tags: (num_facets,) int, 0 = unmarked
        self.facet_markers = np.zeros(self.num_facets, dtype=index_dtype)
        if facet_markers_from is not None:
            self.mark_facets(*facet_markers_from)
        # hierarchy bookkeeping (see module docstring)
        self.level = 0
        self.facet_birth_level = np.zeros(self.num_facets, dtype=index_dtype)
        # vertices of the parent (pre-Alfeld) mesh; everything by default
        self.macro_vertices = np.ones(self.num_vertices, dtype=bool)
        # refinement lineage, filled by refine/alfeld
        self.parent_cell = None  # (nc,) -> parent mesh cell
        self.parent = None  # the Mesh this one was refined from

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    def _build_facets(self):
        d = self.dim
        nc = self.num_cells
        # local facet i = vertices excluding local vertex i
        keep = np.array(
            [[j for j in range(d + 1) if j != i] for i in range(d + 1)],
            dtype=index_dtype,
        )  # (d+1, d)
        cell_facets_verts = self.cells[:, keep]  # (nc, d+1, d)
        flat = _sorted_rows(cell_facets_verts.reshape(nc * (d + 1), d))
        facets, inverse = _row_unique_inverse(flat)
        # geometric facet order: on structured grids this blocks the
        # facet families into contiguous lex planes, making patch index
        # tables sliceable (mesh/renumber.py docstring).  2D default-on;
        # 3D opt-in (the numbering tag orphans existing checkpoints)
        from .renumber import (
            entity_geom_perm,
            facet_geom_perm,
            geom_numbering_3d_enabled,
            geom_numbering_enabled,
        )

        if (d == 2 and geom_numbering_enabled()) or (
                d == 3 and geom_numbering_3d_enabled()):
            perm = (facet_geom_perm(self.vertices, facets) if d == 2
                    else entity_geom_perm(self.vertices, facets))
            rank = np.empty(perm.size, dtype=inverse.dtype)
            rank[perm] = np.arange(perm.size, dtype=inverse.dtype)
            facets = facets[perm]
            inverse = rank[inverse]
        self.facet_vertices = facets.astype(index_dtype)  # (nf, d) sorted
        self.num_facets = facets.shape[0]
        # cell -> facet index map, (nc, d+1)
        self.cell_facets = inverse.reshape(nc, d + 1)
        # facet -> (cell, local) incidence (up to 2)
        nf = self.num_facets
        facet_cells = np.full((nf, 2), -1, dtype=index_dtype)
        facet_local = np.full((nf, 2), -1, dtype=index_dtype)
        order = np.argsort(inverse, kind="stable")
        fidx = inverse[order]
        cell_of = (order // (d + 1)).astype(index_dtype)
        loc_of = (order % (d + 1)).astype(index_dtype)
        starts = np.searchsorted(fidx, np.arange(nf))
        counts = np.diff(np.append(starts, len(fidx)))
        assert counts.max() <= 2, "non-manifold mesh"
        facet_cells[:, 0] = cell_of[starts]
        facet_local[:, 0] = loc_of[starts]
        two = counts == 2
        facet_cells[two, 1] = cell_of[starts[two] + 1]
        facet_local[two, 1] = loc_of[starts[two] + 1]
        self.facet_cells = facet_cells
        self.facet_local = facet_local
        self.exterior_facets = np.where(counts == 1)[0].astype(index_dtype)
        self.interior_facets = np.where(counts == 2)[0].astype(index_dtype)
        if d >= 2:
            self._build_edges()

    def _build_edges(self):
        """Edges (1-dim entities). In 2D these coincide with facets."""
        d = self.dim
        if d == 2:
            self.edge_vertices = self.facet_vertices
            self.cell_edges = self.cell_facets
            self.num_edges = self.num_facets
            return
        # 3D: 6 edges per tet, local order fixed by pair list
        pairs = np.array(
            [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=index_dtype
        )
        self._edge_pairs = pairs
        ev = self.cells[:, pairs]  # (nc, 6, 2)
        flat = _sorted_rows(ev.reshape(-1, 2))
        edges, inverse = _row_unique_inverse(flat)
        from .renumber import entity_geom_perm, geom_numbering_3d_enabled

        if geom_numbering_3d_enabled():
            # geometric edge order (see _build_facets): blocks the
            # seven structured-tet edge families into lex planes
            perm = entity_geom_perm(self.vertices, edges)
            rank = np.empty(perm.size, dtype=inverse.dtype)
            rank[perm] = np.arange(perm.size, dtype=inverse.dtype)
            edges = edges[perm]
            inverse = rank[inverse]
        self.edge_vertices = edges.astype(index_dtype)
        self.num_edges = edges.shape[0]
        self.cell_edges = inverse.reshape(self.num_cells, 6)
        # facet -> its 3 edges: (a,b), (a,c), (b,c) of the sorted facet
        f = self.facet_vertices
        self.facet_edges = np.stack(
            [
                match_rows(self.edge_vertices, f[:, [0, 1]]),
                match_rows(self.edge_vertices, f[:, [0, 2]]),
                match_rows(self.edge_vertices, f[:, [1, 2]]),
            ],
            axis=1,
        )

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------
    def cell_coords(self):
        return self.vertices[self.cells]  # (nc, d+1, d)

    def cell_volumes(self):
        v = self.cell_coords()
        edges = v[:, 1:, :] - v[:, :1, :]
        from math import factorial

        return np.abs(np.linalg.det(edges)) / factorial(self.dim)

    def cell_sizes(self):
        """Firedrake CellSize = cell diameter (max vertex distance)."""
        v = self.cell_coords()
        diff = v[:, :, None, :] - v[:, None, :, :]
        return np.sqrt((diff**2).sum(-1)).max(axis=(1, 2))

    def facet_areas(self):
        v = self.vertices[self.facet_vertices]  # (nf, d, d)
        if self.dim == 2:
            return np.linalg.norm(v[:, 1] - v[:, 0], axis=1)
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)

    def mark_facets(self, tagger):
        """tagger(midpoints (nf, d)) -> int array of tags (0 = skip)."""
        mids = self.vertices[self.facet_vertices].mean(axis=1)
        tags = tagger(mids)
        self.facet_markers = np.asarray(tags, dtype=index_dtype)

    def boundary_facets(self, tags=None):
        ext = self.exterior_facets
        if tags is None:
            return ext
        tags = np.atleast_1d(np.asarray(tags))
        mask = np.isin(self.facet_markers[ext], tags)
        return ext[mask]

    # ------------------------------------------------------------------
    def __repr__(self):
        return (
            f"Mesh(dim={self.dim}, nv={self.num_vertices}, "
            f"nc={self.num_cells}, nf={self.num_facets}, level={self.level})"
        )
