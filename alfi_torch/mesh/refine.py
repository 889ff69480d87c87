"""Mesh refinement: uniform (red) refinement and Alfeld (barycentric) splits.

Replaces DMPlex ``refine()`` and the REFINEALFELD transform the reference
uses (alfi/bary.py:16-27).  Fully vectorised numpy; tracks

* ``parent_cell``  — child cell -> coarse cell (the c2f/f2c maps of
  alfi/bary.py:113-184 fall out of this),
* ``facet_birth_level`` — replacement for the "prolongation" label
  (alfi/solver.py:101-107),
* boundary ``facet_markers`` propagation,
* ``macro_vertices`` for Alfeld meshes (the "MacroVertices" label,
  alfi/bary.py:18-19).

Child ordering contracts (relied on by transfer construction):
* uniform 2D: children of cell c are c*4 .. c*4+3,
* uniform 3D: children of cell c are c*8 .. c*8+7 (Bey refinement with the
  (m02, m13) octahedron diagonal),
* alfeld: children of cell c are c*(d+1)+k, child k opposite local vertex k
  (matching the (d+1)-blocking in alfi/bary.py:151-157).
"""

from __future__ import annotations

import numpy as np

from ..config import index_dtype
from .core import Mesh, _sorted_rows, match_rows
from .renumber import geom_numbering_enabled, vertex_lex_perm


def _transfer_facet_data(coarse, fine, child_facet_verts, parent_facet_idx,
                         new_level):
    """Propagate markers + birth level from coarse facets to their children.

    ``child_facet_verts``: (n, d) vertex tuples (in fine numbering) of fine
    facets that geometrically lie inside coarse facets ``parent_facet_idx``.
    All other fine facets get marker 0 and birth ``new_level``.
    """
    fine.facet_markers = np.zeros(fine.num_facets, dtype=index_dtype)
    fine.facet_birth_level = np.full(fine.num_facets, new_level,
                                     dtype=index_dtype)
    if len(parent_facet_idx):
        fidx = match_rows(fine.facet_vertices,
                          _sorted_rows(child_facet_verts))
        fine.facet_markers[fidx] = coarse.facet_markers[parent_facet_idx]
        fine.facet_birth_level[fidx] = coarse.facet_birth_level[parent_facet_idx]


def refine_uniform(mesh: Mesh) -> Mesh:
    """One level of red refinement (1:4 triangles, 1:8 tets)."""
    d = mesh.dim
    nv = mesh.num_vertices
    cells = mesh.cells
    if d == 2:
        # midpoint vertex of edge e gets id nv + e
        mids = mesh.vertices[mesh.edge_vertices].mean(axis=1)
        verts = np.vstack([mesh.vertices, mids])
        # local edges of a triangle in cell_facets order: facet i opposite
        # vertex i, i.e. facet 0 = (v1,v2), 1 = (v0,v2), 2 = (v0,v1)
        e12 = nv + mesh.cell_facets[:, 0]
        e02 = nv + mesh.cell_facets[:, 1]
        e01 = nv + mesh.cell_facets[:, 2]
        v0, v1, v2 = cells[:, 0], cells[:, 1], cells[:, 2]
        children = np.stack(
            [
                np.stack([v0, e01, e02], 1),
                np.stack([v1, e12, e01], 1),
                np.stack([v2, e02, e12], 1),
                np.stack([e01, e12, e02], 1),
            ],
            axis=1,
        )  # (nc, 4, 3)
        fine_cells = children.reshape(-1, 3)
        n_children = 4
        renumber = geom_numbering_enabled()
    elif d == 3:
        mids = mesh.vertices[mesh.edge_vertices].mean(axis=1)
        verts = np.vstack([mesh.vertices, mids])
        # cell_edges columns follow _edge_pairs order 01,02,03,12,13,23
        m = nv + mesh.cell_edges  # (nc, 6)
        m01, m02, m03, m12, m13, m23 = (m[:, i] for i in range(6))
        v0, v1, v2, v3 = (cells[:, i] for i in range(4))
        # Bey refinement, octahedron diagonal (m02, m13)
        children = np.stack(
            [
                np.stack([v0, m01, m02, m03], 1),
                np.stack([v1, m01, m12, m13], 1),
                np.stack([v2, m02, m12, m23], 1),
                np.stack([v3, m03, m13, m23], 1),
                np.stack([m01, m02, m03, m13], 1),
                np.stack([m01, m02, m12, m13], 1),
                np.stack([m02, m03, m13, m23], 1),
                np.stack([m02, m12, m13, m23], 1),
            ],
            axis=1,
        )  # (nc, 8, 4)
        fine_cells = children.reshape(-1, 4)
        n_children = 8
        from .renumber import geom_numbering_3d_enabled

        renumber = geom_numbering_3d_enabled()
    else:
        raise NotImplementedError(d)

    if renumber:
        # lexicographic fine-vertex order: on structured grids the
        # refined vertex grid becomes a contiguous (y, x) plane, the
        # enabler for the sliced patch smoother (mesh/renumber.py);
        # ``vmap`` remaps any OLD fine vertex id (child facet tuples)
        perm = vertex_lex_perm(verts)
        vmap_ = np.empty(perm.size, dtype=fine_cells.dtype)
        vmap_[perm] = np.arange(perm.size, dtype=fine_cells.dtype)
        verts = verts[perm]
        fine_cells = vmap_[fine_cells]
    else:
        vmap_ = None

    fine = Mesh(verts, fine_cells, name=mesh.name)
    fine.level = mesh.level + 1
    fine.parent = mesh
    fine.parent_cell = np.repeat(
        np.arange(mesh.num_cells, dtype=index_dtype), n_children
    )
    fine.n_children = n_children

    # children of coarse facets, for marker/birth transfer
    if d == 2:
        f = mesh.facet_vertices  # (nf, 2) sorted
        fm = nv + np.arange(mesh.num_facets, dtype=index_dtype)
        child_fv = np.concatenate(
            [
                np.stack([f[:, 0], fm], 1),
                np.stack([f[:, 1], fm], 1),
            ]
        )
        parents = np.tile(np.arange(mesh.num_facets, dtype=index_dtype), 2)
    else:
        f = mesh.facet_vertices  # (nf, 3) sorted a<b<c
        # facet edges (a,b), (a,c), (b,c) in the coarse edge table
        eab = match_rows(mesh.edge_vertices, f[:, [0, 1]])
        eac = match_rows(mesh.edge_vertices, f[:, [0, 2]])
        ebc = match_rows(mesh.edge_vertices, f[:, [1, 2]])
        mab, mac, mbc = nv + eab, nv + eac, nv + ebc
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        child_fv = np.concatenate(
            [
                np.stack([a, mab, mac], 1),
                np.stack([b, mab, mbc], 1),
                np.stack([c, mac, mbc], 1),
                np.stack([mab, mac, mbc], 1),
            ]
        )
        parents = np.tile(np.arange(mesh.num_facets, dtype=index_dtype), 4)
    if vmap_ is not None:
        child_fv = vmap_[child_fv]
    _transfer_facet_data(mesh, fine, child_fv, parents, fine.level)
    fine.macro_vertices = np.ones(fine.num_vertices, dtype=bool)
    return fine


def alfeld(mesh: Mesh) -> Mesh:
    """Barycentric (Alfeld) split: each d-simplex -> d+1 via its centroid.

    Child k of cell c sits at index c*(d+1)+k and is opposite local vertex
    k (contains face k and the centroid).  Coarse facets survive unsplit.
    """
    d = mesh.dim
    nv = mesh.num_vertices
    nc = mesh.num_cells
    centroids = mesh.cell_coords().mean(axis=1)
    verts = np.vstack([mesh.vertices, centroids])
    cvert = nv + np.arange(nc, dtype=index_dtype)
    children = []
    for k in range(d + 1):
        face = [j for j in range(d + 1) if j != k]
        child = np.column_stack([mesh.cells[:, face], cvert])
        children.append(child)
    fine_cells = np.stack(children, axis=1).reshape(-1, d + 1)  # (nc*(d+1), d+1)

    fine = Mesh(verts, fine_cells, name=mesh.name + "_bary")
    fine.level = mesh.level  # same hierarchy level as its uniform source
    fine.parent = mesh
    fine.parent_cell = np.repeat(np.arange(nc, dtype=index_dtype), d + 1)
    fine.n_children = d + 1
    # original facets survive; new facets contain the centroid vertex
    _transfer_facet_data(
        mesh,
        fine,
        mesh.facet_vertices,
        np.arange(mesh.num_facets, dtype=index_dtype),
        # new interior facets must never count as "coarse" at this level
        mesh.level,
    )
    macro = np.zeros(fine.num_vertices, dtype=bool)
    macro[:nv] = True
    fine.macro_vertices = macro
    fine.is_bary = True
    return fine
