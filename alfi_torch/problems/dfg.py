"""DFG 2D-1 cylinder benchmark (examples/dfg/dfg.py; the JAX package's
``problems/dfg.py``): channel [0,2.2]x[0,0.41] with a cylinder at
(0.2,0.2), parabolic inflow U=0.3, char_length 0.1 / char_velocity 0.2 so
that the continuation Re is the benchmark's Reynolds number.  The outflow
is free, so the pressure has no null space."""

from __future__ import annotations

import numpy as np

from ..fem.dirichlet import DirichletBC
from ..mesh import dfg2d_mesh, gmsh_read
from ..problem import NavierStokesProblem


class DfgBenchmarkProblem(NavierStokesProblem):
    def __init__(self, msh=None, n=40):
        self.msh = msh
        self.n = n

    def mesh(self):
        if self.msh is not None:
            return gmsh_read(self.msh)
        return dfg2d_mesh(self.n)

    @staticmethod
    def inflow(x):
        y = x[:, 1]
        U = 0.3
        ux = 4.0 * U * y * (0.41 - y) / 0.41 ** 2
        return np.stack([ux, np.zeros_like(ux)], axis=1)

    def bcs(self, Z):
        return [
            DirichletBC(Z.V, self.inflow, 1),
            DirichletBC(Z.V, (0.0, 0.0), [2, 3]),
        ]

    def has_nullspace(self):
        return False

    def char_length(self):
        return 0.1

    def char_velocity(self):
        return 0.2

    def relaxation_direction(self):
        return "0+:1-"
