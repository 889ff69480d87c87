"""The process group of the distributed solver, and its reductions.

The twin of the JAX package's ``parallel/sharding.py:make_device_mesh``:
one process per rank, joined by ``torch.distributed``, where the JAX
package splits one program over a device mesh.  :func:`make_rank_group`
joins (or creates) a group of exactly ``n`` ranks and refuses a smaller
world, as ``make_device_mesh`` refuses truncation: an n-rank claim is
never checked on fewer ranks.

Each rank's device is explicit, and the backend is the one that serves
it:

* ``device="cuda"``: rank k on ``cuda:<local rank>``, which must exist;
  backend NCCL;
* ``device="cuda:K"``: every rank on ``cuda:K``; with several ranks the
  backend is gloo (NCCL refuses two ranks on one device);
* ``device="cpu"``: gloo.

A device that cannot be served raises, as does a process group that
already runs another backend; nothing switches backend or device on its
own.  gloo takes the buffers on a card as they are (its
``all_reduce`` carries CUDA tensors through host memory itself).

The reductions give every rank the same bits, as ``lax.psum`` does, so
that every host decision of the solve (the Krylov convergence test, the
Givens rotations, Newton's tests) sees the same scalars on every rank:

* :meth:`RankGroup.sum_ordered`: each rank writes its contribution into
  its own row of an (nranks, ...) zero buffer, ``all_reduce`` fills in
  the other rows (adding exact zeros is exact in any order), and each
  rank sums the rows in rank order: the same bits on every rank and from
  run to run, under NCCL and gloo alike;
* :meth:`RankGroup.sum_disjoint`: a plain ``all_reduce`` of a buffer in
  which at most one rank holds a nonzero at each entry (an owned value
  gathered to every rank), which is exact in any order.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist


class RankGroup:
    """This process's rank in a group of ``size`` ranks on ``device``
    under ``backend``; the reductions the distributed solver uses.

    ``timing``: when set, each collective synchronises the device before
    and after it and adds its wall time to ``seconds[tag]`` (for
    measurements; off by default); ``calls[tag]`` counts the collectives
    by the tag their caller gives (the solver's: "exchange", the
    interface sums; "dot", the inner products and other scalars;
    "coarse", the coarse grid's tensors and right-hand sides; "gather",
    the state)."""

    def __init__(self, rank, size, device, backend):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.timing = False
        self.seconds = {}
        self.calls = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_reduce(self, buf, tag="other"):
        """Sum ``buf`` over the ranks in place (one collective)."""
        if self.timing:
            self._sync()
            t0 = time.perf_counter()
        dist.all_reduce(buf)
        if self.timing:
            self._sync()
            self.seconds[tag] = (self.seconds.get(tag, 0.0)
                                 + time.perf_counter() - t0)
        self.calls[tag] = self.calls.get(tag, 0) + 1
        return buf

    def sum_ordered(self, t, tag="dot"):
        """The sum over the ranks of ``t`` (any shape), added in rank
        order: the same bits on every rank."""
        buf = t.new_zeros((self.size,) + tuple(t.shape))
        buf[self.rank] = t
        self.all_reduce(buf, tag)
        out = buf[0]
        for r in range(1, self.size):
            out = out + buf[r]
        return out

    def sum_disjoint(self, t, tag="gather"):
        """The sum over the ranks of ``t``, where at each entry at most one
        rank holds a nonzero: exact, so the same bits on every rank."""
        return self.all_reduce(t.clone(), tag)

    def barrier(self):
        dist.barrier()


def _resolve(n, local_rank, device):
    """(device, backend) for a rank of an n-rank group: the one backend
    that serves the device; raises when the request cannot be served."""
    device = torch.device(device)
    if device.type == "cpu":
        return device, "gloo"
    if device.type != "cuda":
        raise RuntimeError("make_rank_group: device %s" % device)
    if not torch.cuda.is_available():
        raise RuntimeError("make_rank_group: %s requested but CUDA is not "
                           "available" % device)
    if device.index is None:
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(
                "make_rank_group: local rank %d has no card of its own (%d "
                "visible); pass device='cuda:0' to put every rank on one "
                "card under gloo" % (local_rank, count))
        return torch.device("cuda", local_rank), "nccl"
    # NCCL refuses two ranks on one device
    return device, "nccl" if n == 1 else "gloo"


def make_rank_group(n, *, device="cuda", init_method=None, rank=None):
    """This process's :class:`RankGroup` in a group of exactly ``n``
    ranks.

    Joins the default process group when one exists (it must hold exactly
    ``n`` ranks); else creates it: with ``rank`` given, as rank ``rank``
    of ``n`` at ``init_method`` (e.g. ``file://<path>``, a store no two
    groups share); else from the launcher's environment (``torchrun``:
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``env://``).  A world
    smaller (or larger) than ``n`` raises: run under ``torchrun
    --nproc-per-node n``.  A single rank with no launcher gets a store of
    its own."""
    n = int(n)
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != n:
            raise RuntimeError(
                "make_rank_group: %d ranks requested but the process group "
                "has %d" % (n, world))
        rank = dist.get_rank()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        have = dist.get_backend()
        dev, want = _resolve(n, local_rank, device)
        if want != have:
            raise RuntimeError("make_rank_group: the process group runs %s, "
                               "%s needs %s" % (have, dev, want))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return RankGroup(rank, n, dev, have)
    if rank is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != n:
            raise RuntimeError(
                "make_rank_group: %d ranks requested but the world has %d; "
                "run under torchrun --nproc-per-node %d" % (n, world, n))
        rank = int(os.environ.get("RANK", "0"))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        local_rank = int(rank)
    dev, backend = _resolve(n, local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    elif n == 1 and "MASTER_ADDR" not in os.environ:
        kw["store"] = dist.HashStore()
    dist.init_process_group(backend, world_size=n, rank=int(rank), **kw)
    return RankGroup(rank, n, dev, backend)
