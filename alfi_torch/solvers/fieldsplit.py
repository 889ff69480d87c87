"""Block-Schur preconditioner for the AL Navier-Stokes Jacobian.

Explicit block algebra replacing PETSc PCFieldSplit with
``pc_fieldsplit_type schur, factorization full, precondition user``
(alfi/solver.py:405-421) and the user Schur PC ``DGMassInv`` =
-(nu+gamma) Mp^{-1} (alfi/solver.py:15-38).

For J = [[A, B^T], [B, 0]] the full-factorisation application is

    t = A^{-1} rv
    p = S^{-1} (rq - B t)         with S^{-1} ~= -(nu+gamma) Mp^{-1}
    u = t - A^{-1} (B^T p)

where the two A^{-1} are one full-multigrid cycle each for "almg".
"""

from __future__ import annotations

import torch


class SchurPC:
    """apply(r) for residual pairs r = (rv, rq).

    Parameters
    ----------
    form : NSForm (provides B, B^T, and the DG pressure mass inverse)
    mask_u : (ndofV, d) velocity BC row mask
    solve_A : closure rv -> approx A^{-1} rv on (ndofV, d) tensors; must
        return zero rows at BC dofs for zero-row inputs.
    """

    def __init__(self, form, mask_u, solve_A):
        self.form = form
        self.mask_u = mask_u
        self.solve_A = solve_A
        self.minv = form.pressure_mass_inverse()

    def schur_inverse(self, s, params):
        scale = -(params["nu"] + params["gamma"])
        return scale * self.form.apply_pressure_massinv(self.minv, s)

    def make_apply(self, params):
        form = self.form
        mask_u = self.mask_u
        solve_A = self.solve_A

        def apply(r):
            rv, rq = r
            t = solve_A(mask_u * rv)
            s = rq - form.apply_divergence(t)
            p = self.schur_inverse(s, params)
            w = mask_u * form.apply_pressure_gradient(p)
            u = t - solve_A(w)
            return (u, p)

        return apply


def pressure_nullspace_projector(Z):  # noqa: ARG001  (signature parity)
    """Remove the constant-pressure mode (Euclidean, matching PETSc's
    MatNullSpace vector for the basis in alfi/problem.py:33-38)."""

    def project(z):
        u, p = z
        return (u, p - torch.mean(p))

    return project
