"""Simplex quadrature via collapsed (Duffy) Gauss-Jacobi rules.

Arbitrary-degree, positive-weight rules on the reference triangle/tet;
replaces the quadrature schemes TSFC generates for the reference's forms.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.special import roots_jacobi


def _gauss_jacobi01(n, alpha):
    """n-point Gauss-Jacobi rule on [0,1] with weight (1-t)^alpha."""
    x, w = roots_jacobi(n, alpha, 0.0)
    t = 0.5 * (x + 1.0)
    w = w / 2.0 ** (alpha + 1)
    return t, w


@lru_cache(maxsize=None)
def simplex_quadrature(dim, degree):
    """Points (npts, dim) and weights (npts,) integrating exactly all
    polynomials of total degree <= degree over the unit simplex."""
    n = degree // 2 + 1
    if dim == 1:
        t, w = _gauss_jacobi01(n, 0.0)
        return t[:, None], w
    if dim == 2:
        xi, wx = _gauss_jacobi01(n, 0.0)
        eta, we = _gauss_jacobi01(n, 1.0)  # weight (1-eta)
        X, E = np.meshgrid(xi, eta, indexing="ij")
        pts = np.column_stack([(X * (1 - E)).ravel(), E.ravel()])
        wts = np.outer(wx, we).ravel()
        return pts, wts
    if dim == 3:
        xi, wx = _gauss_jacobi01(n, 0.0)
        eta, we = _gauss_jacobi01(n, 1.0)  # (1-eta)
        zeta, wz = _gauss_jacobi01(n, 2.0)  # (1-zeta)^2
        X, E, Z = np.meshgrid(xi, eta, zeta, indexing="ij")
        x = X * (1 - E) * (1 - Z)
        y = E * (1 - Z)
        z = Z
        pts = np.column_stack([x.ravel(), y.ravel(), z.ravel()])
        wts = np.einsum("i,j,k->ijk", wx, we, wz).ravel()
        return pts, wts
    raise NotImplementedError(dim)


@lru_cache(maxsize=None)
def facet_quadrature(dim, degree):
    """Quadrature on the reference (dim-1)-simplex for facet integrals."""
    return simplex_quadrature(dim - 1, degree)
