"""Backwards-facing step problems (2D/3D).

Parity with examples/bfs2d/bfs2d.py and bfs3d/bfs3d.py:
Poiseuille inflow confined to the upper channel (the UFL conditional
``(y > 1)`` becomes a numpy mask), no-slip walls, free outflow (natural
BC), no pressure nullspace."""

from __future__ import annotations

import numpy as np

from ..fem.dirichlet import DirichletBC
from ..mesh import gmsh_read
from ..mesh.domains import bfs2d_mesh, bfs3d_mesh
from ..problem import NavierStokesProblem


class TwoDimBackwardsFacingStepProblem(NavierStokesProblem):
    def __init__(self, msh=None, n=4):
        self.msh = msh
        self.n = n

    def mesh(self):
        if self.msh is not None:
            return gmsh_read(self.msh)
        return bfs2d_mesh(self.n)

    @staticmethod
    def poiseuille_flow(x):
        y = x[:, 1]
        ux = np.where(y > 1, 4 * (2 - y) * (y - 1), 0.0)
        return np.stack([ux, np.zeros_like(ux)], axis=1)

    def bcs(self, Z):
        return [
            DirichletBC(Z.V, self.poiseuille_flow, 1),
            DirichletBC(Z.V, (0.0, 0.0), 2),
        ]

    def has_nullspace(self):
        return False

    def relaxation_direction(self):
        return "0+:1-"


class ThreeDimBackwardsFacingStepProblem(NavierStokesProblem):
    def __init__(self, msh=None, n=2):
        self.msh = msh
        self.n = n

    def mesh(self):
        if self.msh is not None:
            return gmsh_read(self.msh)
        return bfs3d_mesh(self.n)

    @staticmethod
    def poiseuille_flow(x):
        y, z = x[:, 1], x[:, 2]
        ux = np.where(y > 1, 16 * (2 - y) * (y - 1) * z * (1 - z), 0.0)
        zz = np.zeros_like(ux)
        return np.stack([ux, zz, zz], axis=1)

    def bcs(self, Z):
        return [
            DirichletBC(Z.V, self.poiseuille_flow, 1),
            DirichletBC(Z.V, (0.0, 0.0, 0.0), 3),
        ]

    def has_nullspace(self):
        return False

    def relaxation_direction(self):
        return "0+:1-"
