"""Newton's method with the reference's SNES semantics.

Mirrors PETSc ``snes_type newtonls`` with ``snes_linesearch_type basic``
(full step, alfi/solver.py:466-470) and the convergence tests of
SNESConvergedDefault with the tolerance sets of alfi/solver.py:471-499:

* atol:  ||F|| <= atol
* rtol:  ||F|| <= rtol * ||F0||
* stol:  ||dz|| <= stol * ||z||   (converged_snorm)
* max_it 20, divergence when ||F|| is not finite OR exceeds
  dtol * ||F0|| (SNESConvergedDefault's -snes_divergence_tolerance,
  default 1e4).

The loop is a host loop (like SNES's own outer loop) driving the
residual and linear-solve closures; every per-iteration compute stays on
the device and only the norms come back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..utils.tree import taxpy, tnorm


@dataclass
class NewtonInfo:
    converged: bool = False
    reason: str = ""
    nonlinear_iter: int = 0
    linear_iter: int = 0
    fnorm_history: list = field(default_factory=list)


def newton(residual, linear_solve, z0, *, maxit=20, rtol=1e-9, atol=1e-8,
           stol=1e-6, dtol=1e4, monitor=None, norm=tnorm):
    """Solve residual(z) = 0.

    residual(z)            -> BC-row-masked residual (u, p)
    linear_solve(z, F)     -> (dz, linear_iters) solving J(z) dz = -F with
                              dz = 0 on constrained rows
    norm(v)                -> the norm of the tests (a distributed solve's
                              owner-weighted one, the same on every rank)
    """
    z = z0
    info = NewtonInfo()
    F = residual(z)
    fnorm = float(norm(F))
    fnorm0 = fnorm
    info.fnorm_history.append(fnorm)
    if monitor:
        monitor(0, fnorm)
    if fnorm <= atol:
        info.converged, info.reason = True, "atol"
        return z, info
    for it in range(1, maxit + 1):
        dz, lits = linear_solve(z, F)
        info.linear_iter += int(lits)
        z = taxpy(1.0, dz, z)
        info.nonlinear_iter = it
        F = residual(z)
        fnorm = float(norm(F))
        info.fnorm_history.append(fnorm)
        if monitor:
            monitor(it, fnorm)
        if not math.isfinite(fnorm):
            info.converged, info.reason = False, "diverged_fnorm_nan"
            return z, info
        if fnorm > dtol * fnorm0:
            info.converged, info.reason = False, "diverged_dtol"
            return z, info
        if fnorm <= atol:
            info.converged, info.reason = True, "atol"
            return z, info
        if fnorm <= rtol * fnorm0:
            info.converged, info.reason = True, "rtol"
            return z, info
        snorm = float(norm(dz))
        znorm = float(norm(z))
        if snorm <= stol * znorm:
            info.converged, info.reason = True, "stol"
            return z, info
    info.converged, info.reason = False, "max_it"
    return z, info
