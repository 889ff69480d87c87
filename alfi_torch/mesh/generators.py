"""Structured mesh generators + Gmsh MSH 2.2 reader.

``rectangle_mesh``/``box_mesh`` mirror Firedrake's ``RectangleMesh``/
``BoxMesh`` (used by the reference problems, e.g.
examples/ldc2d/ldc2d.py:16-20) including the boundary
numbering the problem BCs rely on: 1: x=0, 2: x=Lx, 3: y=0, 4: y=Ly,
5: z=0, 6: z=Lz, and the ``diagonal`` choice (left/right/crossed).

``gmsh_read`` parses the MSH 2.2 ASCII meshes checked into the reference
(examples/bfs{2,3}d/*.msh, mmsldc{2,3}d/*.msh) with physical-group facet
markers.
"""

from __future__ import annotations

import numpy as np

from ..config import index_dtype
from .core import Mesh


def _axis_tagger(extents):
    """Boundary tagger for axis-aligned boxes: Firedrake numbering."""

    def tagger(mids):
        tol = 1e-10 * max(e[1] - e[0] for e in extents)
        tags = np.zeros(len(mids), dtype=index_dtype)
        tag = 1
        for ax, (lo, hi) in enumerate(extents):
            # assign in reverse precedence so lower-numbered axes win? No:
            # exterior facet midpoints lie on exactly one plane for simplices
            tags[np.abs(mids[:, ax] - lo) < tol] = tag
            tags[np.abs(mids[:, ax] - hi) < tol] = tag + 1
            tag += 2
        return tags

    return tagger


def rectangle_mesh(nx, ny, Lx, Ly, diagonal="left", name="rectangle"):
    x = np.linspace(0.0, Lx, nx + 1)
    y = np.linspace(0.0, Ly, ny + 1)
    if diagonal == "crossed":
        # vertices: grid + cell centres
        X, Y = np.meshgrid(x, y, indexing="ij")
        grid = np.column_stack([X.ravel(), Y.ravel()])
        cx = 0.5 * (x[:-1] + x[1:])
        cy = 0.5 * (y[:-1] + y[1:])
        CX, CY = np.meshgrid(cx, cy, indexing="ij")
        centres = np.column_stack([CX.ravel(), CY.ravel()])
        verts = np.vstack([grid, centres])
        vid = lambda i, j: i * (ny + 1) + j
        I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        I, J = I.ravel(), J.ravel()
        a = vid(I, J)
        b = vid(I + 1, J)
        c = vid(I + 1, J + 1)
        d = vid(I, J + 1)
        m = (nx + 1) * (ny + 1) + I * ny + J
        cells = np.concatenate(
            [
                np.stack([a, b, m], 1),
                np.stack([b, c, m], 1),
                np.stack([c, d, m], 1),
                np.stack([d, a, m], 1),
            ]
        )
    else:
        X, Y = np.meshgrid(x, y, indexing="ij")
        verts = np.column_stack([X.ravel(), Y.ravel()])
        vid = lambda i, j: i * (ny + 1) + j
        I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        I, J = I.ravel(), J.ravel()
        a = vid(I, J)       # (0,0)
        b = vid(I + 1, J)   # (1,0)
        c = vid(I + 1, J + 1)  # (1,1)
        d = vid(I, J + 1)   # (0,1)
        if diagonal == "left":
            # diagonal from (1,0) to (0,1)
            cells = np.concatenate(
                [np.stack([a, b, d], 1), np.stack([b, c, d], 1)]
            )
        elif diagonal == "right":
            # diagonal from (0,0) to (1,1)
            cells = np.concatenate(
                [np.stack([a, b, c], 1), np.stack([a, c, d], 1)]
            )
        else:
            raise ValueError(diagonal)
    mesh = Mesh(verts, cells, name=name)
    mesh.mark_facets(_axis_tagger([(0.0, Lx), (0.0, Ly)]))
    return mesh


_KUHN_TETS = [
    # 6-tet (Kuhn) subdivision of the unit cube, vertices indexed by
    # (i, j, k) bit pattern b = i + 2j + 4k; every tet shares the main
    # diagonal 0-7 so neighbouring cubes are compatible.
    (0, 1, 3, 7),
    (0, 1, 5, 7),
    (0, 2, 3, 7),
    (0, 2, 6, 7),
    (0, 4, 5, 7),
    (0, 4, 6, 7),
]


def box_mesh(nx, ny, nz, Lx, Ly, Lz, name="box"):
    x = np.linspace(0.0, Lx, nx + 1)
    y = np.linspace(0.0, Ly, ny + 1)
    z = np.linspace(0.0, Lz, nz + 1)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    verts = np.column_stack([X.ravel(), Y.ravel(), Z.ravel()])

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    corner = {}
    for b in range(8):
        i, j, k = b & 1, (b >> 1) & 1, (b >> 2) & 1
        corner[b] = vid(I + i, J + j, K + k)
    cells = np.concatenate(
        [np.stack([corner[a] for a in tet], 1) for tet in _KUHN_TETS]
    )
    mesh = Mesh(verts, cells, name=name)
    mesh.mark_facets(_axis_tagger([(0.0, Lx), (0.0, Ly), (0.0, Lz)]))
    return mesh


def unit_square_mesh(n, diagonal="left"):
    return rectangle_mesh(n, n, 1.0, 1.0, diagonal=diagonal)


def unit_cube_mesh(n):
    return box_mesh(n, n, n, 1.0, 1.0, 1.0)


def gmsh_read(path, name=None):
    """Read an ASCII Gmsh MSH 2.2 file (the format of the reference meshes)."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    nodes = None
    elements = []
    while i < len(lines):
        line = lines[i].strip()
        if line == "$Nodes":
            n = int(lines[i + 1])
            data = np.loadtxt(
                [" ".join(l.split()[1:4]) for l in lines[i + 2 : i + 2 + n]]
            ).reshape(n, 3)
            nodes = data
            i += 2 + n
        elif line == "$Elements":
            n = int(lines[i + 1])
            for l in lines[i + 2 : i + 2 + n]:
                parts = l.split()
                etype = int(parts[1])
                ntags = int(parts[2])
                phys = int(parts[3]) if ntags >= 1 else 0
                conn = [int(p) - 1 for p in parts[3 + ntags :]]
                elements.append((etype, phys, conn))
            i += 2 + n
        else:
            i += 1
    if nodes is None:
        raise ValueError(f"no $Nodes in {path}")
    tets = [(phys, conn) for (t, phys, conn) in elements if t == 4]
    tris = [(phys, conn) for (t, phys, conn) in elements if t == 2]
    edges = [(phys, conn) for (t, phys, conn) in elements if t == 1]
    if tets:
        dim = 3
        cells = np.array([c for _, c in tets], dtype=index_dtype)
        bdata = tris
        verts = nodes
    elif tris:
        dim = 2
        cells = np.array([c for _, c in tris], dtype=index_dtype)
        bdata = edges
        verts = nodes[:, :2]
    else:
        raise ValueError("no cells found")
    # drop unused vertices (gmsh files may include isolated points)
    used = np.unique(cells)
    remap = -np.ones(len(verts), dtype=index_dtype)
    remap[used] = np.arange(len(used), dtype=index_dtype)
    verts = verts[used]
    cells = remap[cells]
    mesh = Mesh(verts, cells, name=name or str(path))
    if bdata:
        from .core import match_rows

        bverts = np.sort(
            remap[np.array([c for _, c in bdata], dtype=index_dtype)], axis=1
        )
        keep = np.all(bverts >= 0, axis=1)
        bverts = bverts[keep]
        tags = np.array([p for p, _ in bdata], dtype=index_dtype)[keep]
        fidx = match_rows(mesh.facet_vertices, bverts)
        mesh.facet_markers[fidx] = tags
    return mesh
