"""Flexible GMRES, CG and Chebyshev over tensor / tuple vectors (eager
PyTorch).

Replacement for the PETSc ``ksp_type fgmres`` the reference configures
(alfi/solver.py:305-514), ported from the JAX package's
``solvers/krylov.py:fgmres``: right preconditioning, classical
Gram-Schmidt with one re-orthogonalisation pass (CGS2), Givens rotations,
restarts, an optional nullspace projector, a zero-guess fast path and an
``_EPS``-guarded normalisation instead of a breakdown exit.

Convergence semantics mirror KSPConvergedDefault with unpreconditioned
norms: stop when ||r|| <= max(rtol * ||r0||, atol); for right-
preconditioned (F)GMRES the Givens residual estimate IS the
unpreconditioned residual norm.  Those tests read the residual estimate
on the host (``events.host_read``, counted), one synchronisation per
Arnoldi step.  The fixed-iteration mode of the multigrid smoother
(``rtol=0, atol<0``) tests nothing and so reads nothing: it always runs
``min(maxit, restart)`` steps.
"""

from __future__ import annotations

import torch

from ..utils.events import host_read
from ..utils.tree import (
    leaves,
    taxpy,
    tdot,
    tmap,
    tnorm,
    tscale,
    tsub,
    tzeros_like,
)

_EPS = 1e-300


def _identity(x):
    return x


def _stack_zeros(b, n):
    """Per-leaf (n, *shape) buffers for a Krylov basis."""
    return tuple(torch.zeros((n,) + x.shape, dtype=x.dtype, device=x.device)
                 for x in leaves(b))


def _set(buf, j, v):
    for bl, vl in zip(buf, leaves(v)):
        bl[j] = vl


def _get(buf, j, like):
    out = tuple(bl[j] for bl in buf)
    return out if isinstance(like, tuple) else out[0]


def _buf_dots(buf, w, n, ctx=None):
    """dots[i] = <buf[i], w> for i < n, as one (n,) tensor (through
    ``ctx`` when one is given)."""
    if ctx is not None:
        return ctx.buf_dots(buf, w, n)
    return sum(bl[:n].reshape(n, -1) @ wl.reshape(-1)
               for bl, wl in zip(buf, leaves(w)))


class ShardDotContext:
    """The inner products of a distributed solve: owner-weighted local
    dots (every dof that several ranks hold counts once, on its owner),
    summed over the ranks in rank order by ``group.sum_ordered``
    (``alfi_torch/parallel/sharding.py``), so that every rank sees the
    same bits (the JAX package's ``ShardDotContext``).  ``weight``: 0/1
    owner weights with the vectors' structure, each leaf broadcasting
    against its vector's."""

    def __init__(self, weight, group):
        self.weight = weight
        self.group = group

    def dot(self, a, b):
        loc = sum(torch.sum(wl * x * y) for wl, x, y in
                  zip(leaves(self.weight), leaves(a), leaves(b)))
        return self.group.sum_ordered(loc)

    def norm(self, a):
        return torch.sqrt(self.dot(a, a))

    def buf_dots(self, buf, w, n):
        loc = sum(bl[:n].reshape(n, -1) @ (wt * wl).reshape(-1)
                  for bl, wl, wt in zip(buf, leaves(w),
                                        leaves(self.weight)))
        return self.group.sum_ordered(loc)


def _buf_axpy(buf, coef, w):
    """w - sum_i coef[i] * buf[i]."""
    n = coef.shape[0]
    out = tuple(wl - torch.tensordot(coef, bl[:n], dims=1)
                for bl, wl in zip(buf, leaves(w)))
    return out if isinstance(w, tuple) else out[0]


def fgmres(A, b, pc=None, x0=None, rtol=1e-9, atol=1e-10, maxit=500,
           restart=30, project=None, ctx=None):
    """Right-preconditioned flexible GMRES.

    Parameters
    ----------
    A, pc : vector -> vector closures (pc may be nonlinear/state-
        dependent, e.g. an inner Krylov-smoothed multigrid cycle — that is
        the "flexible" part the reference relies on for almg).
    project : optional nullspace projector applied to operator outputs
        (constant-pressure mode removal, the MatNullSpace analogue of
        alfi/problem.py:33-38).
    ctx : optional :class:`ShardDotContext`: the norms and Gram-Schmidt
        dots of a distributed solve (none: the plain ones).

    Returns
    -------
    (x, info) with info = dict(iters, rnorm, rnorm0, converged); in the
    fixed-iteration mode ``rnorm``/``rnorm0`` are device tensors and
    ``converged`` is None.
    """
    if pc is None:
        pc = _identity
    if project is None:
        project = _identity
    zero_guess = x0 is None
    if zero_guess:
        x0 = tzeros_like(b)
    b = project(b)
    m = restart
    fixed = rtol == 0.0 and atol < 0.0
    if fixed and maxit > restart:
        raise ValueError("the fixed-iteration mode runs one Arnoldi "
                         "cycle: maxit must not exceed restart")
    ref = leaves(b)[0]
    # the scalar state (Hessenberg, Givens, residual estimate) follows the
    # vectors' dtype: an f32 smoother loop never promotes through an f64
    # scalar, and the f64 outer solve is unchanged
    vdt = ref.dtype
    for x in leaves(b)[1:]:
        vdt = torch.promote_types(vdt, x.dtype)

    def opA(v):
        return project(A(v))

    def _norm(v):
        return tnorm(v) if ctx is None else ctx.norm(v).to(vdt)

    # zero initial guess: the residual IS b — no operator application
    # spent before the Krylov loop
    r0 = b if zero_guess else tsub(b, opA(x0))
    rnorm0 = _norm(r0)
    target = None if fixed else max(rtol * host_read(rnorm0), atol)

    def cgs2(V, w, n):
        """Classical Gram-Schmidt with one re-orthogonalisation pass."""
        h1 = _buf_dots(V, w, n, ctx)
        w = _buf_axpy(V, h1, w)
        h2 = _buf_dots(V, w, n, ctx)
        w = _buf_axpy(V, h2, w)
        return w, h1 + h2

    def cycle(x, total_it, r=None):
        if r is None:
            r = tsub(b, opA(x))
        beta = _norm(r)
        V = _stack_zeros(b, m + 1)
        _set(V, 0, tscale(1.0 / (beta + _EPS), r))
        Z = _stack_zeros(b, m)
        R = torch.zeros((m + 1, m), dtype=vdt, device=ref.device)
        rot = torch.zeros((m, 2, 2), dtype=vdt, device=ref.device)
        g = torch.zeros((m + 1,), dtype=vdt, device=ref.device)
        g[0] = beta
        j = 0
        rnorm = beta
        while (j < m and total_it + j < maxit
               and (fixed or host_read(rnorm) > target)):
            z = pc(_get(V, j, b))
            _set(Z, j, z)
            w = opA(z)
            w, h = cgs2(V, w, j + 1)  # orthogonalise against V[0..j]
            hj1 = _norm(w)
            _set(V, j + 1, tscale(1.0 / (hj1 + _EPS), w))
            hcol = torch.zeros((m + 1,), dtype=vdt, device=ref.device)
            hcol[:j + 1] = h
            hcol[j + 1] = hj1
            # apply the stored Givens rotations to the new column
            for i in range(j):
                hcol[i:i + 2] = rot[i] @ hcol[i:i + 2]
            a_, b_ = hcol[j], hcol[j + 1]
            denom = torch.sqrt(a_ * a_ + b_ * b_) + _EPS
            c_new, s_new = a_ / denom, b_ / denom
            rot[j] = torch.stack([torch.stack([c_new, s_new]),
                                  torch.stack([-s_new, c_new])])
            hcol[j] = denom
            hcol[j + 1] = 0.0
            R[:, j] = hcol
            gj = g[j].clone()
            g[j] = c_new * gj
            g[j + 1] = -s_new * gj
            rnorm = torch.abs(g[j + 1])
            j += 1
        if j:
            y = torch.linalg.solve_triangular(
                R[:j, :j], g[:j, None], upper=True)[:, 0]
            x = tmap(lambda xx, zz: xx + torch.tensordot(y, zz[:j], dims=1),
                     x, Z if isinstance(x, tuple) else Z[0])
        return x, total_it + j, rnorm

    if maxit <= restart:
        # at most ONE Arnoldi cycle can run: call it directly with the
        # known initial residual
        x, iters, rnorm = cycle(x0, 0, r0)
    else:
        x, iters, rnorm = x0, 0, rnorm0
        r = r0 if zero_guess else None
        while host_read(rnorm) > target and iters < maxit:
            x, iters, rnorm = cycle(x, iters, r)
            r = None
    info = {
        "iters": iters,
        "rnorm": rnorm,
        "rnorm0": rnorm0,
        "converged": None if fixed else host_read(rnorm) <= target,
    }
    return x, info


def cg(A, b, pc=None, x0=None, rtol=1e-8, atol=1e-50, maxit=200,
       project=None):
    """Preconditioned CG with the unpreconditioned-norm convergence test
    (``ksp_norm_type unpreconditioned`` of the reference's grad-div
    harness, examples/graddiv/graddiv.py:90-96): stop when ||r|| <=
    max(rtol * ||r0||, atol), r the projected residual.  The recurrences
    are the JAX package's ``solvers/krylov.py:cg``; the test reads the
    residual norm on the host, one synchronisation per iteration.

    Returns (x, info) with info = dict(iters, rnorm, rnorm0, converged)."""
    if pc is None:
        pc = _identity
    if project is None:
        project = _identity
    if x0 is None:
        x0 = tzeros_like(b)
    b = project(b)
    r = tsub(b, project(A(x0)))
    rnorm0 = tnorm(r)
    target = max(rtol * host_read(rnorm0), atol)
    z = pc(r)
    p = z
    rz = tdot(r, z)
    x, it, rnorm = x0, 0, rnorm0
    while host_read(rnorm) > target and it < maxit:
        Ap = project(A(p))
        alpha = rz / (tdot(p, Ap) + _EPS)
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, Ap, r)
        z = pc(r)
        rz_new = tdot(r, z)
        beta = rz_new / (rz + _EPS)
        p = taxpy(beta, p, z)
        rz = rz_new
        it += 1
        rnorm = tnorm(r)
    return x, {"iters": it, "rnorm": rnorm, "rnorm0": rnorm0,
               "converged": host_read(rnorm) <= target}


def chebyshev(A, b, pc, x0=None, maxit=2, lmin=None, lmax=None,
              eig_scale=(0.1, 1.1)):
    """Chebyshev smoother, ``maxit`` fixed steps (the grad-div harness's
    level smoother, examples/graddiv/graddiv.py:99-111): linear in b, so
    that the cycle stays a valid CG preconditioner.  Bounds of the
    preconditioned operator: with no ``lmin``, (0.1, 1.1) * ``lmax``.
    The recurrences are the JAX package's ``solvers/krylov.py:chebyshev``."""
    if x0 is None:
        x0 = tzeros_like(b)
    if lmin is None:
        lmin = eig_scale[0] * lmax
        lmax = eig_scale[1] * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    x, d, alpha = x0, tzeros_like(b), 0.0
    for i in range(maxit):
        r = pc(tsub(b, A(x)))
        if i == 0:
            beta, alpha = 0.0, 1.0 / theta
        else:
            beta = (0.5 * delta * alpha) ** 2
            alpha = 1.0 / (theta - beta / (alpha + _EPS))
        d = tmap(lambda dd, rr: beta * dd + rr, d, r)
        x = taxpy(alpha, d, x)
    return x
