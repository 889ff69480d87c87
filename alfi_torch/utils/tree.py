"""Vector-space helpers for the Krylov and Newton loops.

A vector is either one tensor (a velocity field (ndofV, d)) or a tuple of
tensors (the mixed pair (u (ndofV, d), p (ndofQ,))).  These replace
PETSc Vec operations (VecDot/VecAXPY/VecNorm); reductions stay on the
device as 0-d tensors.
"""

import torch


def tmap(fn, *xs):
    """Apply ``fn`` leafwise over vectors of the same structure."""
    if isinstance(xs[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*xs))
    return fn(*xs)


def leaves(x):
    return x if isinstance(x, tuple) else (x,)


def tdot(a, b):
    """Global (flattened) dot product of two vectors, as a 0-d tensor."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(leaves(a), leaves(b)))


def tnorm(a):
    return torch.sqrt(tdot(a, a))


def taxpy(alpha, x, y):
    """alpha * x + y"""
    return tmap(lambda xx, yy: alpha * xx + yy, x, y)


def tscale(alpha, x):
    return tmap(lambda xx: alpha * xx, x)


def tsub(x, y):
    return tmap(torch.sub, x, y)


def tzeros_like(x):
    return tmap(torch.zeros_like, x)
