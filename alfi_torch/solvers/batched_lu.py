"""Dense factorisations of the ill-conditioned AL operators, in f64.

* patches: explicit inverses of a batch of small matrices — the
  reference's own PkP0 trick (``patch_pc_patch_dense_inverse``,
  alfi/solver.py:599-602) and the JAX package's TPU default
  (``_ExplicitInverseFactorization``).  Every smoother or transfer
  application is then one batched GEMV: the hand-written
  ``gather_bgemv`` + ``csr_segment_sum`` kernels (alfi_torch/kernels.py).
* coarse grid: one LU with partial pivoting, solved per application.

Both factorisations are library calls (``torch.linalg``), as the JAX
package leaves them to XLA.  kappa(A) ~ gamma/nu * h^-2 reaches 1e7-1e9,
so both stay f64.
"""

from __future__ import annotations

import torch


def patch_inverses(A):
    """(np, m, m) -> (np, m, m) explicit inverses."""
    return torch.linalg.inv(A)


def coarse_factor(A):
    """Dense LU factorisation (LU, pivots) of one (N, N) matrix."""
    return torch.linalg.lu_factor(A)


def coarse_solve(fac, b):
    """Solve with a :func:`coarse_factor` result; b is (N,)."""
    LU, piv = fac
    return torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]
