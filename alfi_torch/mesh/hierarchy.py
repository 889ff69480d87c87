"""Mesh hierarchies for geometric multigrid.

Replaces firedrake.MeshHierarchy and the reference's BaryMeshHierarchy
(alfi/bary.py:29-194).  Three kinds, matching
alfi/problem.py:10-24:

* ``uniform``      — nested red-refinement chain,
* ``bary``         — every level is the Alfeld split of the corresponding
                     uniform level (levels are pairwise NON-nested; the
                     c2f maps between bary levels follow the (d+1)-blocking
                     of alfi/bary.py:151-157),
* ``uniformbary``  — Alfeld the base once, then refine uniformly (nested).
"""

from __future__ import annotations

import numpy as np

from ..config import index_dtype
from .core import Mesh
from .refine import alfeld, refine_uniform


class MeshHierarchy:
    def __init__(self, meshes, kind, uniform_meshes=None):
        self.meshes = list(meshes)
        self.kind = kind
        #: for kind == "bary": the parallel chain of uniform meshes
        self.uniform_meshes = uniform_meshes

    def __len__(self):
        return len(self.meshes)

    def __getitem__(self, i):
        return self.meshes[i]

    def __iter__(self):
        return iter(self.meshes)

    @property
    def nested(self):
        return self.kind != "bary"

    def coarse_to_fine_cells(self, clevel):
        """(nc_coarse, m) map from coarse cells to the fine cells covering
        them, between hierarchy levels clevel -> clevel+1."""
        fine = self.meshes[clevel + 1]
        coarse = self.meshes[clevel]
        d = fine.dim
        if self.kind == "bary":
            # coarse bary cell cb = u*(d+1)+k; fine bary cells are the
            # Alfeld children of the uniform children of u.
            u_fine = self.uniform_meshes[clevel + 1]
            nch = u_fine.n_children  # uniform 4 or 8
            ncb = coarse.num_cells
            cb = np.arange(ncb, dtype=index_dtype)
            u = cb // (d + 1)  # parent uniform coarse cell
            fine_u = u[:, None] * nch + np.arange(nch, dtype=index_dtype)
            fine_b = (
                fine_u[:, :, None] * (d + 1)
                + np.arange(d + 1, dtype=index_dtype)
            ).reshape(ncb, nch * (d + 1))
            return fine_b
        nch = fine.n_children
        nc = coarse.num_cells
        return (
            np.arange(nc, dtype=index_dtype)[:, None] * nch
            + np.arange(nch, dtype=index_dtype)
        )

    def fine_to_coarse_cell(self, flevel):
        """(nc_fine,) -> containing/overlapping coarse uniform-parent cell.

        For the bary hierarchy this is the *set* relation collapsed to the
        uniform parent: fine bary cell -> coarse uniform cell; combine with
        Alfeld point location for exact queries (see transfer module).
        """
        fine = self.meshes[flevel]
        if self.kind == "bary":
            u_fine = self.uniform_meshes[flevel]
            # fine bary cell -> fine uniform cell -> coarse uniform cell
            return u_fine.parent_cell[fine.parent_cell]
        return fine.parent_cell


def mesh_hierarchy(base: Mesh, kind: str, nref: int) -> MeshHierarchy:
    if kind == "uniform":
        meshes = [base]
        for _ in range(nref):
            meshes.append(refine_uniform(meshes[-1]))
        return MeshHierarchy(meshes, kind)
    if kind == "bary":
        uniform = [base]
        for _ in range(nref):
            uniform.append(refine_uniform(uniform[-1]))
        meshes = [alfeld(m) for m in uniform]
        return MeshHierarchy(meshes, kind, uniform_meshes=uniform)
    if kind == "uniformbary":
        meshes = [alfeld(base)]
        # reset: the bary base acts as level 0 of a nested chain
        meshes[0].level = 0
        meshes[0].facet_birth_level = np.zeros(
            meshes[0].num_facets, dtype=index_dtype
        )
        for _ in range(nref):
            meshes.append(refine_uniform(meshes[-1]))
        return MeshHierarchy(meshes, kind)
    raise ValueError(f"unknown hierarchy kind {kind!r}")
