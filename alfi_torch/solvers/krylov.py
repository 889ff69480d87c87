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
``min(maxit, restart)`` steps, in an :class:`Arnoldi` workspace that the
smoother keeps per level; on the card its vector work replays as CUDA
graphs (:class:`GraphCapture`) between eager preconditioner and operator
launches.
"""

from __future__ import annotations

import torch

from ..utils.events import COUNTERS, host_read
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


class GraphCapture:
    """The CUDA graphs of the fixed-iteration mode's vector work, the
    :class:`Arnoldi` workspaces that replay them (one per multigrid level
    and dtype, in :attr:`workspaces`) and the one arena of buffers those
    workspaces share.

    Graphs are captured on a side stream (a capture cannot run on the
    default stream) into one private memory pool, whose blocks their
    temporaries share, and replay one at a time on the default stream.
    They live as long as this object: a pool whose graphs have all been
    freed cannot be captured into again, so drop the object with them.
    Captures skip what ``torch.cuda.graph`` adds around one (a device
    synchronise and an emptied cache), and count in
    ``COUNTERS["smoother_graph_captures"]``.

    Only one cycle runs at a time, so every workspace lays its buffers
    from the start of one arena of ``nbytes`` (the largest workspace's,
    :meth:`Arnoldi.nbytes`): allocated at each cycle from a memory pool
    that nothing else allocates from, always at that size, and freed when
    the cycle returns.  It thus lies at one address, which the graphs
    hold.

    cuBLAS keeps a workspace per stream (32 MiB on an H100), and a
    capture makes the side stream's in the graph pool.  It is dropped
    after each capture (as PyTorch's own graph trees do), so that the
    allocator counts it free, as it counts the graphs' temporaries and
    the arena between cycles.  The replays still use that memory: the two
    pools hold all of it for this object's life, reserved on the device
    and out of the other allocations' reach."""

    def __init__(self, device, nbytes):
        device = torch.device(device)
        if device.index is None:  # the pool's context wants an index
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self.nbytes = device, nbytes
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.arena_pool = torch.cuda.MemPool()
        self.ptr = None
        self.workspaces = {}

    def workspace(self, key, b, m):
        """The workspace ``key`` (made at its first call) for ``m`` steps
        on vectors like ``b``."""
        ws = self.workspaces.get(key)
        if ws is None:
            ws = self.workspaces[key] = Arnoldi(b, m, capture=self)
        return ws

    def arena(self):
        """The arena, allocated now; it is freed with the last view of
        it."""
        with torch.cuda.use_mem_pool(self.arena_pool, self.device):
            arena = torch.empty((self.nbytes,), dtype=torch.uint8,
                                device=self.device)
        if self.ptr is None:
            self.ptr = arena.data_ptr()
        elif arena.data_ptr() != self.ptr:
            raise RuntimeError("the smoother's arena moved: its graphs "
                               "hold another address")
        return arena

    def __call__(self, fn):
        """The graph of ``fn()``'s launches (``fn`` runs once, capturing;
        nothing executes until a replay)."""
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        torch._C._cuda_clearCublasWorkspaces()
        COUNTERS["smoother_graph_captures"] += 1
        return graph


def _scalar_dtype(b):
    """The dtype of the Hessenberg, Givens and residual scalars: the
    vectors' (promoted over a tuple's leaves), so that an f32 smoother
    loop never promotes through an f64 scalar."""
    vdt = leaves(b)[0].dtype
    for x in leaves(b)[1:]:
        vdt = torch.promote_types(vdt, x.dtype)
    return vdt


#: each buffer of a fixed-mode workspace starts at a multiple of this
#: many bytes, where the allocator would put a tensor of its own
_ALIGN = 512


def _layout(shape, dtype, m):
    """The fixed mode's buffers V, Z, w, x, R, rot, g and s as (byte
    offset, element count, shape), and their total bytes."""
    n = shape.numel()
    views = [((m + 1) * n, (m + 1,) + shape), (m * n, (m,) + shape),
             (n, shape), (n, shape), ((m + 1) * m, (m + 1, m)),
             (4 * m, (m, 2, 2)), (m + 1, (m + 1,)), (2, (2,))]
    out, total = [], 0
    for count, view in views:
        out.append((total, count, view))
        total += -(-count * dtype.itemsize // _ALIGN) * _ALIGN
    return out, total


class Arnoldi:
    """One Arnoldi cycle of at most ``m`` steps on vectors shaped like
    ``b``: its buffers and its three stages, shared by both modes of
    :func:`fgmres`.

    Buffers: the basis V (m + 1 vectors), the preconditioned directions
    Z (m), the rotated Hessenberg R (m + 1, m), the Givens rotations
    (m, 2, 2) and the rotated right-hand side g (m + 1,).  A stage reads
    only what the same cycle wrote.  ``ctx``: the dot products of a
    distributed solve (:class:`ShardDotContext`).

    The converging mode takes fresh buffers for each cycle
    (:meth:`zeros`; vectors may be tuples).  The fixed mode (:meth:`cycle`,
    one tensor) lays them out in one arena held for a cycle, with two
    more vector slots, ``w`` (the start's residual, then each step's
    operator output) and ``x`` (the initial guess, then the result), and
    ``s`` (beta and the final |g[n]|): a plain allocation of its own, or,
    with ``capture`` (a :class:`GraphCapture`; no ``ctx``), the capture's
    shared arena.  Its stages (the start, each step j and the solution)
    then run as CUDA graphs, captured at their first call and replayed
    after, and the preconditioner and the operator stay outside them,
    launched eagerly between replays."""

    def __init__(self, b, m, ctx=None, capture=None):
        if capture is not None and ctx is not None:
            raise ValueError("a captured Arnoldi cycle takes no dot "
                             "context (its collectives stay eager)")
        self.m, self.ctx, self.capture = m, ctx, capture
        self.vdt = _scalar_dtype(b)
        self.shapes = [x.shape for x in leaves(b)]
        self.device = leaves(b)[0].device
        self.graphs = {}
        if not isinstance(b, tuple):
            self.views, self.total = _layout(b.shape, b.dtype, m)
            if capture is not None and self.total > capture.nbytes:
                raise ValueError("the workspace does not fit the capture's "
                                 "arena")

    @staticmethod
    def nbytes(shape, dtype, m):
        """The bytes of a fixed-mode workspace's buffers."""
        return _layout(torch.Size(shape), dtype, m)[1]

    def zeros(self, b):
        """Fresh zeroed buffers for vectors like ``b``."""
        m, dev = self.m, self.device
        self.V = _stack_zeros(b, m + 1)
        self.Z = _stack_zeros(b, m)
        self.R = torch.zeros((m + 1, m), dtype=self.vdt, device=dev)
        self.rot = torch.zeros((m, 2, 2), dtype=self.vdt, device=dev)
        self.g = torch.zeros((m + 1,), dtype=self.vdt, device=dev)
        return self

    def _bind(self):
        """Point the fixed mode's buffers into an arena."""
        if self.capture is None:
            arena = torch.empty((self.total,), dtype=torch.uint8,
                                device=self.device)
        else:
            arena = self.capture.arena()
        V, Z, self.w, self.x, self.R, self.rot, self.g, self.s = (
            arena[o:o + count * self.vdt.itemsize].view(self.vdt).view(view)
            for o, count, view in self.views)
        self.V, self.Z = (V,), (Z,)

    def _unbind(self):
        """Drop the views (the arena is freed with the last)."""
        self.V = self.Z = self.w = self.x = None
        self.R = self.rot = self.g = self.s = None

    def norm(self, v):
        if self.ctx is None:
            return tnorm(v)
        return self.ctx.norm(v).to(self.vdt)

    def start(self, r):
        """V[0] = r / ||r||, g[0] = ||r||; returns ||r|| (beta)."""
        beta = self.norm(r)
        _set(self.V, 0, tscale(1.0 / (beta + _EPS), r))
        self.g[0] = beta
        return beta

    def step(self, j, w):
        """Arnoldi step j on the operator's output ``w`` = A Z[j]."""
        V, m = self.V, self.m
        # classical Gram-Schmidt against V[0..j], one re-orthogonalisation
        h1 = _buf_dots(V, w, j + 1, self.ctx)
        w = _buf_axpy(V, h1, w)
        h2 = _buf_dots(V, w, j + 1, self.ctx)
        w = _buf_axpy(V, h2, w)
        hj1 = self.norm(w)
        _set(V, j + 1, tscale(1.0 / (hj1 + _EPS), w))
        hcol = torch.zeros((m + 1,), dtype=self.vdt, device=self.g.device)
        hcol[:j + 1] = h1 + h2
        hcol[j + 1] = hj1
        # apply the stored Givens rotations to the new column
        for i in range(j):
            hcol[i:i + 2] = self.rot[i] @ hcol[i:i + 2]
        a_, b_ = hcol[j], hcol[j + 1]
        denom = torch.sqrt(a_ * a_ + b_ * b_) + _EPS
        c_new, s_new = a_ / denom, b_ / denom
        self.rot[j] = torch.stack([torch.stack([c_new, s_new]),
                                   torch.stack([-s_new, c_new])])
        hcol[j] = denom
        # on the device: a Python scalar written into a CUDA tensor waits
        # for the host
        hcol[j + 1].zero_()
        self.R[:, j] = hcol
        gj = self.g[j].clone()
        self.g[j] = c_new * gj
        self.g[j + 1] = -s_new * gj

    def solution(self, x, n):
        """x + Z[:n]^T y, y solving the rotated (n, n) triangle R y = g."""
        y = torch.linalg.solve_triangular(
            self.R[:n, :n], self.g[:n, None], upper=True)[:, 0]
        return tmap(lambda xx, zz: xx + torch.tensordot(y, zz[:n], dims=1),
                    x, self.Z if isinstance(x, tuple) else self.Z[0])

    def _run(self, key, fn):
        """Stage ``key``: ``fn()`` itself, or the replay of its graph."""
        if self.capture is None:
            fn()
            if isinstance(key, int):
                COUNTERS["smoother_eager_steps"] += 1
            return
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = self.capture(fn)
        graph.replay()
        COUNTERS["smoother_graph_replays"] += 1

    def _start(self):
        self.s[0] = self.start(self.w)

    def _solution(self, n):
        self.x.copy_(self.solution(self.x, n))
        self.s[1] = torch.abs(self.g[n])

    def cycle(self, opA, pc, b, x0, n):
        """``n`` (<= m) steps from ``x0`` (None: zero) on one tensor,
        testing nothing: (x0 + Z y, beta, |g[n]|), tensors of their
        own."""
        r = b if x0 is None else tsub(b, opA(x0))
        self._bind()
        try:
            if x0 is None:
                self.x.zero_()
            else:
                self.x.copy_(x0)
            self.w.copy_(r)
            self._run("start", self._start)
            V, Z = self.V[0], self.Z[0]
            for j in range(n):
                z = pc(V[j])
                Z[j] = z
                self.w.copy_(opA(z))
                self._run(j, lambda j=j: self.step(j, self.w))
            self._run(("solution", n), lambda: self._solution(n))
            s = self.s.clone()
            return self.x.clone(), s[0], s[1]
        finally:
            self._unbind()


def fgmres(A, b, pc=None, x0=None, rtol=1e-9, atol=1e-10, maxit=500,
           restart=30, project=None, ctx=None, workspace=None):
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
    workspace : optional :class:`Arnoldi` of the fixed-iteration mode,
        kept by the caller from call to call (a multigrid level's
        smoother, :meth:`GraphCapture.workspace`), whose stages replay as
        CUDA graphs.  None: a fresh workspace, run eagerly.

    Returns
    -------
    (x, info) with info = dict(iters, rnorm, rnorm0, converged); in the
    fixed-iteration mode (one tensor ``b``) ``rnorm``/``rnorm0`` are device
    tensors and ``converged`` is None.
    """
    if pc is None:
        pc = _identity
    if project is None:
        project = _identity
    b = project(b)
    m = restart

    def opA(v):
        return project(A(v))

    if rtol == 0.0 and atol < 0.0:
        if maxit > restart:
            raise ValueError("the fixed-iteration mode runs one Arnoldi "
                             "cycle: maxit must not exceed restart")
        if isinstance(b, tuple):
            raise ValueError("the fixed-iteration mode takes one tensor")
        if workspace is None:
            workspace = Arnoldi(b, m, ctx=ctx)
        elif (ctx is not None or workspace.m < maxit
              or workspace.shapes != [b.shape] or workspace.vdt != b.dtype):
            raise ValueError("the workspace does not fit this call")
        x, rnorm0, rnorm = workspace.cycle(opA, pc, b, x0, maxit)
        return x, {"iters": maxit, "rnorm": rnorm, "rnorm0": rnorm0,
                   "converged": None}
    if workspace is not None:
        raise ValueError("a workspace serves the fixed-iteration mode")
    zero_guess = x0 is None
    if zero_guess:
        x0 = tzeros_like(b)

    # zero initial guess: the residual IS b — no operator application
    # spent before the Krylov loop
    r0 = b if zero_guess else tsub(b, opA(x0))
    rnorm0 = (tnorm(r0) if ctx is None
              else ctx.norm(r0).to(_scalar_dtype(b)))
    target = max(rtol * host_read(rnorm0), atol)

    def cycle(x, total_it, r=None):
        if r is None:
            r = tsub(b, opA(x))
        arn = Arnoldi(b, m, ctx=ctx).zeros(b)
        rnorm = arn.start(r)
        j = 0
        while j < m and total_it + j < maxit and host_read(rnorm) > target:
            z = pc(_get(arn.V, j, b))
            _set(arn.Z, j, z)
            arn.step(j, opA(z))
            rnorm = torch.abs(arn.g[j + 1])
            j += 1
        if j:
            x = arn.solution(x, j)
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
        "converged": host_read(rnorm) <= target,
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
