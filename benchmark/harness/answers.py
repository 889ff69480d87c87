"""Reading the program's states in the reference's numbering.

The program returns a state as (u (ndof, d), p (ncells,)) in its own dof
numbering; every dof is a point value at a node whose coordinates the
program's function spaces list.  The reference numbers its own nodes.  The
two are matched by coordinates, on the lattice of a sixth (velocity) or
twelfth (cell centroids) of the mesh spacing, on which every node of the
configurations lies; a node that misses the lattice or finds no partner
stops the check.
"""

from __future__ import annotations

import numpy as np


def lattice_keys(coords, step):
    """One int64 key per point of ``coords`` (n, d) on the lattice of
    ``step``; raises for a point off it."""
    k = np.asarray(coords, dtype=np.float64) / step
    r = np.round(k)
    if np.abs(k - r).max(initial=0.0) > 1e-6:
        raise ValueError("a node lies off the lattice of step %g" % step)
    r = r.astype(np.int64)
    if r.min(initial=0) < 0:
        raise ValueError("a node lies outside the box")
    base = int(r.max(initial=0)) + 1
    return r @ (base ** np.arange(r.shape[1], dtype=np.int64))


def match(program_coords, reference_coords, step):
    """``perm`` with program_coords[perm[i]] at reference_coords[i]; raises
    unless the two point sets are the same."""
    kp = lattice_keys(program_coords, step)
    kr = lattice_keys(reference_coords, step)
    if len(kp) != len(kr):
        raise ValueError("%d program nodes against %d reference nodes"
                         % (len(kp), len(kr)))
    op = np.argsort(kp, kind="stable")
    orr = np.argsort(kr, kind="stable")
    if not np.array_equal(kp[op], kr[orr]) or len(np.unique(kr)) != len(kr):
        raise ValueError("the program's nodes are not the reference's")
    perm = np.empty(len(kr), dtype=np.int64)
    perm[orr] = op
    return perm


class StateReader:
    """Reorders program states onto the reference's velocity nodes and
    cells, by the program's node coordinates (``u_coords``, ``p_coords``)
    read once at set-up."""

    def __init__(self, reference, u_coords, p_coords, spacing):
        self.u_perm = match(u_coords, reference.node_coords, spacing / 6.0)
        self.p_perm = match(p_coords, reference.cell_centroids,
                            spacing / 12.0)

    def __call__(self, u, p):
        return np.asarray(u)[self.u_perm], np.asarray(p)[self.p_perm]
