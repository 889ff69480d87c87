"""Linearised operators and dense assembly for the mixed system.

* the matrix-free Jacobian action is ``torch.func.jvp`` of the residual
  (the JAX package uses ``jax.linearize``, which evaluates the primal
  once; ``jvp`` evaluates it again on every call — one extra residual
  per outer Krylov iteration);
* dense velocity operators are assembled from per-cell element tensors
  and, with Burman's stabilisation, per-interior-facet tensors (the MG
  coarse grid), with BC rows/cols eliminated to identity.
"""

from __future__ import annotations

import numpy as np
import torch


def make_jacobian_matvec(residual_fn, bcset, z, params):
    """v -> J(z) v with eliminated rows/cols (identity on BC dofs).

    residual_fn(z, params) must be the RAW (un-masked) residual; masking
    happens here so the Jacobian stays consistent with the masked
    residual used by Newton."""

    def f(zz):
        return residual_fn(zz, params)

    def matvec(v):
        _, Jv = torch.func.jvp(f, (z,), (bcset.zero(v),))
        return bcset.identity_rows(bcset.zero_rows(Jv), v)

    return matvec


def vector_rows(space):
    """(nc, nloc*d) host table (numpy int64) of flattened global row
    indices of a vector space, with flat index dof*d + component (the
    BAIJ-like blocking of alfi/solver.py:512)."""
    d = space.value_size
    cd = np.asarray(space.cell_dofs, dtype=np.int64)
    return (cd[:, :, None] * d + np.arange(d)[None, None, :]).reshape(
        cd.shape[0], -1)


def assemble_dense_from_tensors(form, T, mask_u, facet_tensors=None,
                                facet_rows=None):
    """Dense (N, N) velocity operator from per-cell tensors T
    (nc, nld, nld), optionally plus interior-facet tensors (the Burman
    stabilised Jacobian, ``facet_tensors`` (nif, 2*nld, 2*nld) on the
    host table ``facet_rows`` (nif, 2*nld)); BC rows/cols eliminated to
    identity."""
    N = form.V.ndof * form.dim

    def flat(rows):
        rows = torch.as_tensor(rows, device=T.device)
        return (rows[:, :, None] * N + rows[:, None, :]).reshape(-1)

    A = torch.zeros((N * N,), dtype=T.dtype, device=T.device).index_add(
        0, flat(vector_rows(form.V)), T.reshape(-1))
    if facet_tensors is not None:
        A = A.index_add(0, flat(facet_rows), facet_tensors.reshape(-1))
    A = A.reshape(N, N)
    m = mask_u.reshape(-1)
    return m[:, None] * A * m[None, :] + torch.diag(1.0 - m)
