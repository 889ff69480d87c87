"""Method-of-manufactured-solutions lid-driven cavity, 2D and 3D (the JAX
package's ``problems/mms.py``).

Shih-Tan-Hwang exact solution on [0,2]^2 (examples/mmsldc2d/mmsldc2d.py:
41-79); the 3D problem extends it z-independently with w = 0 on [0,2]^3
(examples/mmsldc3d/mmsldc3d.py).  The exact fields are torch functions of
one point; the forcing applies the strong-form operators to them with
``torch.func`` (jacfwd, hessian, grad; vmap over the points), as the JAX
package does with jax — exact to rounding and consistent with the
residual kernels.  The BCs take numpy nodal values: the same functions,
evaluated on the CPU."""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..fem.dirichlet import DirichletBC
from ..mesh import box_mesh, rectangle_mesh
from ..problem import NavierStokesProblem


def _f(x):
    return x**4 - 2 * x**3 + x**2


def _df(x):
    return 4 * x**3 - 6 * x**2 + 2 * x


def _g(y):
    return y**4 - y**2


def _dg(y):
    return 4 * y**3 - 2 * y


def _u_unit(xy):
    """Exact velocity on the unit square (divergence-free)."""
    x, y = xy[0], xy[1]
    return torch.stack([8 * _f(x) * _dg(y), -8 * _df(x) * _g(y)])


def _p_unit(xy, inv_re):
    x, y = xy[0], xy[1]
    F = 0.2 * x**5 - 0.5 * x**4 + (1.0 / 3.0) * x**3
    F2 = 0.5 * _f(x) ** 2
    dddg = 24 * y
    ddg = 12 * y**2 - 2
    return (8.0 * inv_re) * (F * dddg + _df(x) * _dg(y)) + 64 * F2 * (
        _g(y) * ddg - _dg(y) ** 2
    )


class TwoDimLidDrivenCavityMMSProblem(NavierStokesProblem):
    def __init__(self, baseN, diagonal="left"):
        self.baseN = baseN
        self.diagonal = diagonal

    def mesh(self):
        return rectangle_mesh(self.baseN, self.baseN, 2, 2,
                              diagonal=self.diagonal)

    # exact fields on [0,2]^2 (X -> X/2 rescaling of the unit solution,
    # examples/mmsldc2d/mmsldc2d.py:63-65); 8/Re = 4 nu since
    # Re = char_L * char_U / nu with char_L = 2.
    def u_exact(self, xy):
        return _u_unit(0.5 * xy)

    def p_exact(self, xy, nu):
        # inv_re = nu / (L*U) = nu / 2; the additive constant is fixed by
        # the mean-zero comparison of ErrorComputer.pressure_error
        return _p_unit(0.5 * xy, 0.5 * nu)

    def _exact_np(self, x):
        """The exact velocity at host points x (n, d), as numpy."""
        pts = torch.as_tensor(np.asarray(x), dtype=real_dtype)
        return torch.func.vmap(self.u_exact)(pts).numpy()

    def bcs(self, Z):
        return [
            DirichletBC(Z.V, self._exact_np, 4),
            DirichletBC(Z.V, (0.0, 0.0), [1, 2, 3]),
        ]

    def has_nullspace(self):
        return True

    def char_length(self):
        return 2.0

    def relaxation_direction(self):
        return "0+:1-"

    def rhs(self):
        """Strong-form forcing:
        f = -nu div(2 sym grad u) + advect (grad u) u + grad p;  f_q = 0
        (u is exactly divergence-free)."""
        u_exact, p_exact = self.u_exact, self.p_exact

        def f_point(x, nu, advect):
            gu = torch.func.jacfwd(u_exact)(x)  # (i, j) = d_j u_i
            H = torch.func.jacfwd(torch.func.jacfwd(u_exact))(x)  # (i,j,k)
            visc = torch.einsum("ijj->i", H) + torch.einsum("jij->i", H)
            conv = gu @ u_exact(x)
            gp = torch.func.grad(lambda xx: p_exact(xx, nu))(x)
            return -nu * visc + advect * conv + gp

        def rhs_fn(xq, params):
            nu, advect = params["nu"], params.get("advect", 1.0)
            f_v = torch.func.vmap(lambda x: f_point(x, nu, advect))(xq)
            return f_v, xq.new_zeros(xq.shape[0])

        return rhs_fn


class ThreeDimLidDrivenCavityMMSProblem(TwoDimLidDrivenCavityMMSProblem):
    """3D MMS cavity (examples/mmsldc3d/mmsldc3d.py): the 2D fields
    extended z-independently with w = 0, on [0,2]^3; lid at y=2 (tag 4),
    the exact solution vanishes on the other walls."""

    def mesh(self):
        return box_mesh(self.baseN, self.baseN, self.baseN, 2, 2, 2)

    def u_exact(self, xyz):
        u2 = _u_unit(0.5 * xyz[:2])
        return torch.cat([u2, u2.new_zeros(1)])

    def p_exact(self, xyz, nu):
        return _p_unit(0.5 * xyz[:2], 0.5 * nu)

    def bcs(self, Z):
        # exact values on the faces where the (z-independent) solution is
        # nonzero: y=2, z=0, z=2 — tags [4, 5, 6]; it vanishes on x=0,
        # x=2, y=0 (examples/mmsldc3d/mmsldc3d.py:24-27)
        return [
            DirichletBC(Z.V, self._exact_np, [4, 5, 6]),
            DirichletBC(Z.V, (0.0, 0.0, 0.0), [1, 2, 3]),
        ]
