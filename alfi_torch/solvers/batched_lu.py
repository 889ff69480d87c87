"""Dense factorisations of the ill-conditioned AL operators, in f64.

* patches: explicit inverses of a batch of small matrices — the
  reference's own PkP0 trick (``patch_pc_patch_dense_inverse``,
  alfi/solver.py:599-602) and the JAX package's TPU default
  (``_ExplicitInverseFactorization``).  Every smoother or transfer
  application is then one batched GEMV: the hand-written fused
  gather-GEMV-scatter kernel (alfi_torch/kernels.py).
* coarse grid, and the whole system of the direct modes ``lu`` and
  ``allu``: one LU with partial pivoting, solved per application.

Both factorisations are library calls (``torch.linalg``), as the JAX
package leaves them to XLA.  kappa(A) ~ gamma/nu * h^-2 reaches 1e7-1e9,
so both stay f64.
"""

from __future__ import annotations

import torch


def patch_inverses(A):
    """(np, m, m) -> (np, m, m) explicit inverses."""
    # one call for the whole batch, no chunks: at the largest table, the
    # 3D Scott-Vogelius k=3 macrostar patches (125 x 1590^2, 2.53 GB), the
    # process peaked at 21.9 GB on an 80 GB H100 during this call, about
    # 12 GB of it other solvers' (chip_smoke.py phase 3b)
    return torch.linalg.inv(A)


def coarse_factor(A):
    """Dense LU factorisation of one (N, N) matrix, in A's own buffer: A
    is overwritten.  A^T, a column-major view of the row-major A, is
    factored in place with no copy (the direct modes' matrices reach
    13.8 GB at the bench config), so the solve takes the adjoint."""
    At = A.mT
    piv = torch.empty(A.shape[0], dtype=torch.int32, device=A.device)
    return torch.linalg.lu_factor(At, out=(At, piv))


def coarse_solve(fac, b, transpose=False):
    """Solve A x = b (``transpose``: A^T x = b, the adjoint solve) with a
    :func:`coarse_factor` result; b is (N,).  The factors are A^T's, so
    A's solve takes their adjoint and A^T's the plain branch."""
    LU, piv = fac
    return torch.linalg.lu_solve(LU, piv, b[:, None],
                                 adjoint=not transpose)[:, 0]
