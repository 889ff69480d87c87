"""Lid-driven cavity problem (2D; the 3D cavity is a later slice).

Behavioural parity with examples/ldc2d/ldc2d.py: [0,2]^2 cavity,
regularised polynomial lid profile on the top boundary, no-slip
elsewhere, enclosed flow (pressure nullspace), sweep direction "0+:1-"
for multiplicative patch relaxation."""

from __future__ import annotations

import numpy as np

from ..fem.dirichlet import DirichletBC
from ..mesh import rectangle_mesh
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
