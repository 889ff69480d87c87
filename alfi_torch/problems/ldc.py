"""Lid-driven cavity problems (2D / 3D).

Behavioural parity with examples/ldc2d/ldc2d.py and ldc3d/ldc3d.py:
[0,2]^d cavity, regularised polynomial lid profile on the top boundary,
no-slip elsewhere, enclosed flow (pressure nullspace), sweep direction
"0+:1-" for multiplicative patch relaxation."""

from __future__ import annotations

import numpy as np

from ..fem.dirichlet import DirichletBC
from ..mesh import box_mesh, rectangle_mesh
from ..problem import NavierStokesProblem


class TwoDimLidDrivenCavityProblem(NavierStokesProblem):
    def __init__(self, baseN, diagonal=None, regularised=True):
        self.baseN = baseN
        self.diagonal = diagonal or "left"
        self.regularised = regularised

    def mesh(self):
        return rectangle_mesh(self.baseN, self.baseN, 2, 2,
                              diagonal=self.diagonal)

    def driver(self, x):
        # quartic lid profile: x^2 (2-x)^2 * (y^2/4), zero at the corners
        # (examples/ldc2d/ldc2d.py:29-35)
        xx, yy = x[:, 0], x[:, 1]
        if self.regularised:
            ux = xx * xx * (2 - xx) * (2 - xx) * 0.25 * yy * yy
        else:
            ux = 0.25 * yy * yy
        return np.stack([ux, np.zeros_like(ux)], axis=1)

    def bcs(self, Z):
        return [
            DirichletBC(Z.V, self.driver, 4),
            DirichletBC(Z.V, (0.0, 0.0), [1, 2, 3]),
        ]

    def has_nullspace(self):
        return True

    def char_length(self):
        return 2.0

    def relaxation_direction(self):
        return "0+:1-"


class ThreeDimLidDrivenCavityProblem(NavierStokesProblem):
    """[0,2]^3 cavity, lid at y=2 (examples/ldc3d/ldc3d.py)."""

    def __init__(self, baseN):
        self.baseN = baseN

    def mesh(self):
        return box_mesh(self.baseN, self.baseN, self.baseN, 2, 2, 2)

    def driver(self, x):
        # lid at y = 2 (tag 4), regularised profile
        # (examples/ldc3d/ldc3d.py:24-27)
        xx, yy, zz = x[:, 0], x[:, 1], x[:, 2]
        ux = (xx * xx * (2 - xx) * (2 - xx)
              * zz * zz * (2 - zz) * (2 - zz) * 0.25 * yy * yy)
        z = np.zeros_like(ux)
        return np.stack([ux, z, z], axis=1)

    def bcs(self, Z):
        return [
            DirichletBC(Z.V, self.driver, 4),
            DirichletBC(Z.V, (0.0, 0.0, 0.0), [1, 2, 3, 5, 6]),
        ]

    def has_nullspace(self):
        return True

    def char_length(self):
        return 2.0

    def relaxation_direction(self):
        return "0+:1-"
