"""Dirichlet boundary conditions for the mixed (u, p) system on the device.

A BC is resolved ONCE on the host into (dof indices, nodal values)
(:class:`~alfi_torch.fem.dirichlet.DirichletBC`); the device sees only a
0/1 row mask pair and a values pair:

* solutions are kept feasible:      z   <- mask * z + values
* residual / Jacobian rows vanish:  F   <- mask * F
* Newton updates stay tangent:      J v <- mask * Jvp(mask * v) + (1-mask) v

which is exactly the eliminated-row treatment PETSc applies for the
reference (identity rows on constrained dofs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from .dirichlet import DirichletBC  # noqa: F401  (re-export)


class BCSet:
    """All BCs of a mixed space, compiled to (u, p) mask/value tensors on
    ``device``.

    BCs are applied in list order; a dof constrained twice takes the LAST
    value (Firedrake's sequential-application semantics, relevant at e.g.
    lid-cavity corners)."""

    def __init__(self, Z, bcs, pin_pressure=False, *, device):
        self.Z = Z
        V, Q = Z.V, Z.Q
        d = V.value_size
        mask_u = np.ones((V.ndof, d))
        vals_u = np.zeros((V.ndof, d))
        mask_p = np.ones((Q.ndof,))
        vals_p = np.zeros((Q.ndof,))
        for bc in bcs:
            vals = bc.nodal_values()
            if bc.space is V:
                mask_u[bc.dofs] = 0.0
                vals_u[bc.dofs] = vals
            elif bc.space is Q:
                mask_p[bc.dofs] = 0.0
                vals_p[bc.dofs] = vals
            else:
                raise ValueError("BC space is not a component of Z")
        if pin_pressure:
            mask_p[0] = 0.0
            vals_p[0] = 0.0

        def dev(a):
            return torch.as_tensor(a, dtype=real_dtype, device=device)

        self.mask = (dev(mask_u), dev(mask_p))
        self.values = (dev(vals_u), dev(vals_p))

    # ------------------------------------------------------------------
    def apply(self, z):
        """Overwrite constrained dofs with their boundary values."""
        return tuple(m * x + g for m, g, x in zip(self.mask, self.values, z))

    def zero_rows(self, r):
        """Zero residual rows at constrained dofs (bc.zero of the
        reference's residual check, alfi/solver.py:283-287)."""
        return tuple(m * x for m, x in zip(self.mask, r))

    def zero(self, z):
        """Zero constrained dofs (homogeneous form of apply)."""
        return tuple(m * x for m, x in zip(self.mask, z))

    def identity_rows(self, r, v):
        """mask*r + (1-mask)*v : eliminated-row Jacobian action."""
        return tuple(m * rr + (1.0 - m) * vv
                     for m, rr, vv in zip(self.mask, r, v))
