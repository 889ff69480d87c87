"""Lightweight event timing registry.

The port's stand-in for PETSc's event logging (alfi/driver.py:77-92,
alfi/transfer.py:186-192 @timed_function): named wall-clock
accumulators around device computations.  A timed function synchronises
the devices that hold its outputs before it reads the clock, so that
asynchronous CUDA launches do not hide the cost.  Event names mirror the
reference's so that reports stay comparable (SNESSolve, KSPSolve,
SNESFunctionEval).

Beside them, the program's spans and its counters:

* :func:`span` (and :func:`spanned`, its decorator form) marks a layer of
  the solve (``alfi.re_step``, ``alfi.pc_apply``, ``alfi.smooth``, ...) as
  a ``torch.profiler.record_function`` range while a profiler records, so
  that the range sits on the trace's own clock beside the card's kernels
  and each launch is tied to the innermost range open at that moment.
  With no profiler recording it is one probe of the profiler's enabled
  flag and a shared no-op context: no clock read, no allocation.
* ``COUNTERS["host_reads"]`` counts the device-to-host scalar reads of
  the solve path, each made by :func:`host_read` (always on: one int add
  per read, which itself drains the device's queue);
  ``COUNTERS["jacobian_assembled"]`` and ``COUNTERS["jacobian_jvp"]``
  count the outer Krylov's Jacobian actions by the path each took (the
  multigrid set-up's assembled operator, or ``torch.func.jvp`` of the
  residual: ``solvers/linear.py``), one int add per action;
  ``COUNTERS["facet_jacobians"]`` counts the interior facets whose
  Burman Jacobians a multigrid set-up forms, over all its levels
  (``mg/velocity.py``), one int add per set-up;
  ``COUNTERS["smoother_graph_captures"]`` and
  ``COUNTERS["smoother_graph_replays"]`` count the CUDA graphs of the
  fixed-iteration FGMRES smoother's vector work captured and replayed
  (``solvers/krylov.py:Arnoldi``: a start, one graph per Arnoldi step, a
  solution), and ``COUNTERS["smoother_eager_steps"]`` its Arnoldi steps
  run uncaptured (on the CPU, or with a distributed solve's dot context),
  one int add each.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from functools import wraps

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function as _record_function

EVENTS: dict = defaultdict(lambda: {"time": 0.0, "count": 0})

#: the program's counters; :func:`reset` zeroes them
COUNTERS: dict = {"host_reads": 0, "jacobian_assembled": 0,
                  "jacobian_jvp": 0, "facet_jacobians": 0,
                  "smoother_graph_captures": 0, "smoother_graph_replays": 0,
                  "smoother_eager_steps": 0}

# event names whose cold (first) call was already attributed elsewhere
_WARMED: set = set()

# the one context every span returns while no profiler records
_OFF = nullcontext()


def reset():
    EVENTS.clear()
    _WARMED.clear()
    for key in COUNTERS:
        COUNTERS[key] = 0


def span(name):
    """A context marking the layer ``name``: a profiler range while a
    ``torch.profiler`` profile records, else a shared no-op."""
    if _profiler_enabled():
        return _record_function(name)
    return _OFF


def spanned(name):
    """Decorator: every call of the function runs inside ``span(name)``
    (with no profiler recording, after the probe alone)."""

    def deco(fn):
        @wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def host_read(t):
    """``float(t)`` of a device scalar, counted in
    ``COUNTERS["host_reads"]`` and marked by the span ``alfi.host_read``:
    the read waits for every launch before it."""
    COUNTERS["host_reads"] += 1
    with span("alfi.host_read"):
        return float(t)


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
