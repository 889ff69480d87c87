"""Reading the program's states in the reference's numbering.

The program returns a state as (u (ndof, d), p (npdof,)) in its own dof
numbering; every dof is a point value at a node whose coordinates the
program's function spaces list, and every pressure dof belongs to one cell
(``Z.Q.cell_dofs``).  The reference numbers its own nodes.  The two are
matched by coordinates, on one lattice of the mesh spacing h, h/144, that
holds every node of the discretisations on the roadmap: P2 and P3 nodes
on plain and barycentric meshes (h/6, h/8, h/9, h/12), the barycentres
(h/3 in 2D, h/4 in 3D), and the centroids of barycentric sub-cells (h/9
in 2D, h/16 in 3D):

* a velocity dof by its point;
* a pressure dof by the pair (its cell, its point): the cells by their
  centroids, then the nodes of each pair of matched cells by point.  So a
  discontinuous pressure, whose neighbouring cells hold dofs at one point
  (Scott-Vogelius' P1disc at the vertices), is read as well as one dof per
  cell (P0 at the centroid).

What the reference states (its ``Reference`` class or instance):
``node_coords`` (nnodes, d), ``cell_centroids`` (nc, d) and, where a cell
holds more than one pressure dof, ``pressure_nodes`` (nc, nodes per cell,
d), in its own cell order; without it each cell's one node is its
centroid.  The reference's p is then read cell by cell and node by node,
``p.reshape(nc, nodes per cell)``, which is (nc,) for P0.

A node off the lattice, a node with no partner, counts that differ, or a
repeated point among the velocity nodes, among the cells' centroids or
within one cell's pressure nodes stops the check.
"""

from __future__ import annotations

import numpy as np

#: the divisor of the mesh spacing h whose lattice holds every node
LATTICE = 144


def lattice_keys(*point_sets, step):
    """One int64 key per point of each of ``point_sets`` ((n, d) each) on
    the lattice of ``step``, in one numbering for all of them; raises for
    a point off the lattice or outside the box."""
    pts = []
    for coords in point_sets:
        k = np.asarray(coords, dtype=np.float64) / step
        r = np.round(k)
        if np.abs(k - r).max(initial=0.0) > 1e-6:
            raise ValueError("a node lies off the lattice of step %g" % step)
        r = r.astype(np.int64)
        if r.min(initial=0) < 0:
            raise ValueError("a node lies outside the box")
        pts.append(r)
    base = max(int(r.max(initial=0)) for r in pts) + 1
    if base ** pts[0].shape[-1] >= 2 ** 63:
        raise ValueError("the lattice's keys overflow int64")
    w = base ** np.arange(pts[0].shape[-1], dtype=np.int64)
    return [r @ w for r in pts]


def match_rows(program_points, reference_points, step):
    """``perm`` (n, k) with program_points[i, perm[i, j]] at
    reference_points[i, j], for point sets (n, k, d) paired row by row;
    raises unless each pair of rows holds the same points, none repeated."""
    if program_points.shape != reference_points.shape:
        raise ValueError("the program's nodes %s are not the reference's %s"
                         % (program_points.shape[:2],
                            reference_points.shape[:2]))
    n, k, d = reference_points.shape
    kp, kr = (x.reshape(n, k) for x in lattice_keys(
        program_points.reshape(-1, d), reference_points.reshape(-1, d),
        step=step))
    op = np.argsort(kp, axis=1, kind="stable")
    orr = np.argsort(kr, axis=1, kind="stable")
    sr = np.take_along_axis(kr, orr, axis=1)
    if (sr[:, 1:] == sr[:, :-1]).any():
        raise ValueError("the reference repeats a node")
    if not np.array_equal(np.take_along_axis(kp, op, axis=1), sr):
        raise ValueError("the program's nodes are not the reference's")
    perm = np.empty_like(orr)
    np.put_along_axis(perm, orr, op, axis=1)
    return perm


def match(program_coords, reference_coords, step):
    """``perm`` with program_coords[perm[i]] at reference_coords[i]; raises
    unless the two point sets (n, d) are the same, none repeated."""
    return match_rows(np.asarray(program_coords)[None],
                      np.asarray(reference_coords)[None], step)[0]


class StateReader:
    """Reorders program states onto the reference's velocity nodes and
    per-cell pressure nodes, by the program's finest ``mesh`` (vertices,
    cells) and ``nodes`` (velocity dof coordinates, pressure dof
    coordinates, the pressure's cell-to-dof map), read once at set-up;
    ``spacing`` is the mesh spacing h."""

    def __init__(self, reference, mesh, nodes, spacing):
        step = spacing / LATTICE
        u_coords, p_coords, p_cell_dofs = nodes
        self.u_perm = match(u_coords, reference.node_coords, step)
        vertices, cells = mesh
        centroids = np.asarray(reference.cell_centroids)
        cell_perm = match(vertices[cells].mean(axis=1), centroids, step)
        ref_nodes = getattr(reference, "pressure_nodes", None)
        if ref_nodes is None:
            ref_nodes = centroids[:, None, :]
        dofs = np.asarray(p_cell_dofs, dtype=np.int64)[cell_perm]
        local = match_rows(np.asarray(p_coords)[dofs], np.asarray(ref_nodes),
                           step)
        self.p_perm = np.take_along_axis(dofs, local, axis=1).ravel()
        if not np.array_equal(np.sort(self.p_perm),
                              np.arange(len(p_coords))):
            raise ValueError("the program's pressure dofs are not one to a "
                             "reference node")

    def __call__(self, u, p):
        return np.asarray(u)[self.u_perm], np.asarray(p)[self.p_perm]
