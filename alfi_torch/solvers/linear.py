"""Linearised operators, dense assembly and direct solves for the mixed
system (the reference's "lu"/"allu" branches, alfi/solver.py:396-421).

* the outer Krylov's Jacobian action: for almg, the multigrid set-up's
  assembled finest level operator (the velocity block) plus B^T and B
  (:func:`make_assembled_jacobian_matvec`), where that operator is the
  exact Newton Jacobian's block in f64; otherwise ``torch.func.jvp`` of
  the residual (:func:`make_jacobian_matvec`; the JAX package uses
  ``jax.linearize``, which evaluates the primal once; ``jvp`` evaluates
  it again on every call); its transpose, for the adjoint solve, one
  ``torch.func.vjp`` of the residual;
* dense operators are assembled from per-cell element tensors (the whole
  mixed Jacobian for ``lu``, the velocity block for ``allu`` and the MG
  coarse grid) and, with Burman's stabilisation, per-interior-facet
  tensors, with BC rows/cols eliminated to identity.  Each is built in
  one (N, N) buffer, the elimination in place: at the bench config the
  mixed matrix alone is 13.8 GB in f64;
* the direct solves factor that buffer in place with cuSOLVER's LU
  (``solvers/batched_lu.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.scatter import ScatterAdd
from ..utils.events import COUNTERS, span
from .batched_lu import coarse_factor, coarse_solve


def flatten_mixed(z):
    """(u, p) -> one flat vector [u dofs (dof*d + comp) | p dofs]."""
    u, p = z
    return torch.cat([u.reshape(-1), p])


def unflatten_mixed(x, Z):
    nV = Z.V.ndof * Z.V.value_size
    return (x[:nV].reshape(Z.V.ndof, Z.V.value_size), x[nV:])


def make_jacobian_matvec(residual_fn, bcset, z, params):
    """v -> J(z) v with eliminated rows/cols (identity on BC dofs), by
    ``torch.func.jvp`` of the residual: every call evaluates the residual
    and its tangent again (with SUPG, its quadrature-degree hessians).

    The outer FGMRES of allu, alamg, simple and lsc runs on it, and almg's
    where its multigrid set-up holds no exact velocity block (see
    :func:`make_assembled_jacobian_matvec`).  residual_fn(z, params) must
    be the RAW (un-masked) residual; masking happens here so the Jacobian
    stays consistent with the masked residual used by Newton.  Each call
    counts in ``COUNTERS["jacobian_jvp"]``."""

    def f(zz):
        return residual_fn(zz, params)

    def matvec(v):
        COUNTERS["jacobian_jvp"] += 1
        with span("alfi.jacobian_matvec"):
            _, Jv = torch.func.jvp(f, (z,), (bcset.zero(v),))
            return bcset.identity_rows(bcset.zero_rows(Jv), v)

    return matvec


def make_assembled_jacobian_matvec(form, bcset, apply_A):
    """The operator of :func:`make_jacobian_matvec` from an assembled
    velocity block: ``apply_A(u)`` = M A (M u) + (I - M) u, A the velocity
    block of the Newton Jacobian at the state (almg: the multigrid set-up's
    finest level operator, kernel KM), and the pressure couplings from the
    form, B^T = ``apply_pressure_gradient``, B = ``apply_divergence``:

        J [u; p] = [A u + B^T p; B u]   on the BC-zeroed v,

    then the BC rows as identity.  It is that Jacobian only where the
    residual's pressure enters through -(p, div v) alone and its pressure
    rows are -(div u, q) alone: no stabilisation, Burman's, or SUPG on a P0
    pressure (whose strong residual has no pressure gradient), not GLS.
    Each call counts in ``COUNTERS["jacobian_assembled"]``."""

    def matvec(v):
        COUNTERS["jacobian_assembled"] += 1
        with span("alfi.jacobian_matvec"):
            u, p = bcset.zero(v)
            Jv = (apply_A(u) + form.apply_pressure_gradient(p),
                  form.apply_divergence(u))
            return bcset.identity_rows(bcset.zero_rows(Jv), v)

    return matvec


def make_jacobian_rmatvec(residual_fn, bcset, z, params):
    """v -> the transpose of :func:`make_jacobian_matvec`'s operator,
    M J(z)^T M v + (I - M) v: J^T from one torch.func.vjp of the raw
    residual at z, whose function every application reuses (the adjoint
    solve's operator; the JAX package transposes the masked jvp with
    jax.linear_transpose)."""
    _, vjp = torch.func.vjp(lambda zz: residual_fn(zz, params), z)

    def rmatvec(v):
        (JTv,) = vjp(bcset.zero_rows(v))
        return bcset.identity_rows(bcset.zero(JTv), v)

    return rmatvec


def vector_rows(space):
    """(nc, nloc*d) host table (numpy int64) of flattened global row
    indices of a vector space, with flat index dof*d + component (the
    BAIJ-like blocking of alfi/solver.py:512)."""
    d = space.value_size
    cd = np.asarray(space.cell_dofs, dtype=np.int64)
    return (cd[:, :, None] * d + np.arange(d)[None, None, :]).reshape(
        cd.shape[0], -1)


def _scatter_dense(A, blocks):
    """Add per-entity dense blocks into the (N, N) buffer A in place, in
    a fixed order (:class:`~alfi_torch.fem.scatter.ScatterAdd`);
    ``blocks``: (row table (ne, a) host int, col table (ne, b) host int,
    values (ne, a, b))."""
    N = A.shape[0]
    flat = A.view(-1)
    for rows, cols, T in blocks:
        rows = torch.as_tensor(rows, device=A.device)
        cols = torch.as_tensor(cols, device=A.device)
        idx = rows[:, :, None] * N + cols[:, None, :]
        ScatterAdd(idx, N * N).add_(flat, T.reshape(-1))


def _eliminate(A, m):
    """m A m + diag(1 - m), in place: BC rows/cols to identity."""
    A.mul_(m[:, None]).mul_(m[None, :])
    A.diagonal().add_(1.0 - m)
    return A


def assemble_dense_mixed(form, z, params, bcset):
    """Global dense Jacobian of the mixed residual at z, BC-eliminated
    (the ``lu`` mode's matrix).  Layout: [u dofs (dof*d + comp) | p
    dofs]; the cell Jacobian blocks are :meth:`NSForm.mixed_element_tensors`
    (no stabilisation term, as in the JAX package)."""
    Juu, Jup, Jpu, Jpp = form.mixed_element_tensors(z, params)
    nV = form.V.ndof * form.dim
    N = nV + form.Q.ndof
    rv = vector_rows(form.V)
    rq = nV + np.asarray(form.Q.cell_dofs, dtype=np.int64)
    A = torch.zeros((N, N), dtype=Juu.dtype, device=Juu.device)
    _scatter_dense(A, [(rv, rv, Juu), (rv, rq, Jup), (rq, rv, Jpu),
                       (rq, rq, Jpp)])
    return _eliminate(A, flatten_mixed(bcset.mask))


def assemble_dense_velocity(form, wind, params, mask_u):
    """Dense velocity-block Jacobian (viscous + grad-div + linearised
    advection at ``wind``, no stabilisation term), BC-eliminated: the
    ``allu`` mode's matrix."""
    T = form.velocity_element_tensors(params, wind)  # (nc, nlv*d, nlv*d)
    return assemble_dense_from_tensors(form, T, mask_u)


def assemble_dense_from_tensors(form, T, mask_u, facet_tensors=None,
                                facet_rows=None):
    """Dense (N, N) velocity operator from per-cell tensors T
    (nc, nld, nld), optionally plus interior-facet tensors (the Burman
    stabilised Jacobian, ``facet_tensors`` (nif, 2*nld, 2*nld) on the
    host table ``facet_rows`` (nif, 2*nld)); BC rows/cols eliminated to
    identity."""
    N = form.V.ndof * form.dim
    rows = vector_rows(form.V)
    A = torch.zeros((N, N), dtype=T.dtype, device=T.device)
    blocks = [(rows, rows, T)]
    if facet_tensors is not None:
        blocks.append((facet_rows, facet_rows, facet_tensors))
    _scatter_dense(A, blocks)
    return _eliminate(A, mask_u.reshape(-1))


def lu_solve_closure(A):
    """The full-accuracy direct solve (the MUMPS analogue,
    alfi/solver.py:396-403): factor A once (LU with partial pivoting,
    f64, in A's own buffer: A is overwritten) and return x -> A^{-1} x
    on flat vectors."""
    fac = coarse_factor(A)
    return lambda b: coarse_solve(fac, b)
