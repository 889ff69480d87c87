"""Lightweight event timing registry.

The port's stand-in for PETSc's event logging (alfi/driver.py:77-92,
alfi/transfer.py:186-192 @timed_function): named wall-clock
accumulators around device computations.  A timed function synchronises
the devices that hold its outputs before it reads the clock, so that
asynchronous CUDA launches do not hide the cost.  Event names mirror the
reference's so that reports stay comparable (SNESSolve, KSPSolve,
SNESFunctionEval).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

EVENTS: dict = defaultdict(lambda: {"time": 0.0, "count": 0})

# event names whose cold (first) call was already attributed elsewhere
_WARMED: set = set()


def reset():
    EVENTS.clear()
    _WARMED.clear()


def _cuda_devices(out, found):
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    return found


@contextmanager
def timed_region(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ev = EVENTS[name]
        ev["time"] += dt
        ev["count"] += 1


def timed_function(name, first_to=None):
    """Accumulate wall-clock under ``name``.  With ``first_to``, the
    FIRST-ever recorded call of ``name`` is attributed to that event
    instead: the first call builds kernels and initialises libraries,
    a one-off set-up cost that would make a per-iteration event wrong."""

    def deco(fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            for dev in _cuda_devices(out, set()):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            target = name
            if first_to is not None and name not in _WARMED:
                _WARMED.add(name)
                target = first_to
            ev = EVENTS[target]
            ev["time"] += dt
            ev["count"] += 1
            return out

        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    return deco
