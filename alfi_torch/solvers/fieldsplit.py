"""Block-Schur preconditioner for the AL Navier-Stokes Jacobian.

Explicit block algebra replacing PETSc PCFieldSplit with
``pc_fieldsplit_type schur, factorization full, precondition user``
(alfi/solver.py:405-421) and the user Schur PC ``DGMassInv`` =
-(nu+gamma) Mp^{-1} (alfi/solver.py:15-38).

For J = [[A, B^T], [B, 0]] the full-factorisation application is

    t = A^{-1} rv
    p = S^{-1} (rq - B t)         with S^{-1} ~= -(nu+gamma) Mp^{-1}
    u = t - A^{-1} (B^T p)

where the two A^{-1} are one full-multigrid cycle each for "almg", a
dense LU solve for "allu", one AMG V-cycle for "alamg", "simple" and
"lsc"; "lsc" replaces S^{-1} by the Least-Squares Commutator
(:class:`LSCSchurPC`).
"""

from __future__ import annotations

import numpy as np
import torch

from .krylov import cg


class SchurPC:
    """apply(r) for residual pairs r = (rv, rq).

    Parameters
    ----------
    form : NSForm (provides B, B^T, and the DG pressure mass inverse)
    mask_u : (ndofV, d) velocity BC row mask
    solve_A : closure rv -> approx A^{-1} rv on (ndofV, d) tensors; must
        return zero rows at BC dofs for zero-row inputs.
    """

    #: subclasses that never read ``minv`` (LSC) skip computing it
    needs_minv = True

    def __init__(self, form, mask_u, solve_A):
        self.form = form
        self.mask_u = mask_u
        self.solve_A = solve_A
        self.minv = (form.pressure_mass_inverse() if self.needs_minv
                     else None)

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


class LSCSchurPC(SchurPC):
    """Least-Squares Commutator Schur approximation, the reference's
    non-AL competitor mode (``--solver-type lsc``, alfi/solver.py:447-460:
    PCLSC with hypre inner solves, gamma forced to 0 at :127-128), ported
    from the JAX package's ``solvers/fieldsplit.py:LSCSchurPC``.

    For S = -B A^{-1} B^T the LSC preconditioner is

        S^{-1} ~= -(B B^T)^{-1} (B A B^T) (B B^T)^{-1}

    each (B B^T)^{-1} a short CG on L = B M B^T (M the velocity BC mask;
    ``l_iters`` steps at most, ``l_rtol``), the hypre-preonly analogue.
    L is assembled once per PC from the per-cell blocks of B (a CSR
    matrix on the PC's device: one sparse matvec per CG step, where the
    JAX package applies B and B^T matrix-free; the same operator to
    round-off).  For enclosed flows the constant pressure lies in
    null(B^T) = null(L); the CG and its result are kept orthogonal to it
    by mean removal.

    ``apply_A``: the masked velocity Jacobian action at the current
    Newton state, (ndofV, d) -> (ndofV, d) (the AMG fine operator)."""

    needs_minv = False

    def __init__(self, form, mask_u, solve_A, apply_A, has_nullspace,
                 l_iters=30, l_rtol=1e-6, L=None):
        super().__init__(form, mask_u, solve_A)
        self.apply_A = apply_A
        self.has_nullspace = has_nullspace
        self.l_iters = l_iters
        self.l_rtol = l_rtol
        #: L = B M B^T (:func:`pressure_laplacian`; a solver passes the one
        #: it keeps)
        self.L = pressure_laplacian(form, mask_u) if L is None else L

    def _project(self, q):
        if self.has_nullspace:
            return q - torch.mean(q)
        return q

    def _solve_L(self, s):
        """(B M B^T)^{-1} s by CG."""
        x, _ = cg(lambda q: self._project(self.L @ q), self._project(s),
                  pc=None, rtol=self.l_rtol, atol=0.0, maxit=self.l_iters)
        return self._project(x)

    def schur_inverse(self, s, params):
        form, mask_u = self.form, self.mask_u
        q1 = self._solve_L(s)
        w = mask_u * form.apply_pressure_gradient(q1)
        q2 = form.apply_divergence(mask_u * self.apply_A(w))
        return -self._solve_L(q2)


def pressure_laplacian(form, mask_u):
    """L = B diag(mask) B^T as a CSR matrix on the form's device, summed on
    the host (scipy) from the per-cell blocks of B^T; B^T p is
    form.apply_pressure_gradient(p), B u form.apply_divergence(u)."""
    from scipy.sparse import coo_matrix, diags

    from .linear import vector_rows

    Bt = form.gradient_element_tensors().cpu().numpy()  # (nc, nld, nlq)
    rows = vector_rows(form.V)
    cols = form.Q.cell_dofs.astype(np.int64)
    nc, nld, nlq = Bt.shape
    B = coo_matrix((Bt.transpose(0, 2, 1).reshape(-1),
                    (np.repeat(cols, nld, axis=1).reshape(-1),
                     np.tile(rows, (1, nlq)).reshape(-1))),
                   shape=(form.Q.ndof, form.V.ndof * form.dim)).tocsr()
    L = (B @ diags(mask_u.reshape(-1).cpu().numpy()) @ B.T).tocsr()
    L.sort_indices()
    dev = mask_u.device
    return torch.sparse_csr_tensor(
        torch.as_tensor(L.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(L.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(L.data, dtype=mask_u.dtype, device=dev),
        size=L.shape)


def pressure_nullspace_projector(Z):  # noqa: ARG001  (signature parity)
    """Remove the constant-pressure mode (Euclidean, matching PETSc's
    MatNullSpace vector for the basis in alfi/problem.py:33-38)."""

    def project(z):
        u, p = z
        return (u, p - torch.mean(p))

    return project
