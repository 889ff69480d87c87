"""Spans and counters of a traced run, recorded from the benchmark's own
code: wrappers set on the solver instance around the calls into its
layers.  Nothing inside the program is changed.

* ``bench.mg_setup``: each ``VelocityMG.setup`` call (the multigrid set-up
  of a Newton step: tensors, patch inverses, coarse LU, level operators),
  synchronised on both sides and timed by the host clock;
* ``bench.k1``: each patch apply (the smoother's and the Schoeberl
  transfer's patch tables), with the bytes it needs (``bounds.k1_counts``);
* ``bench.km``: each level apply, with its bytes (``bounds.km_counts``).

The ranges are ``torch.profiler.record_function`` ranges: the trace reader
sums the device time of the kernels launched inside them.  Counters go to
the sweep that :meth:`Spans.begin_sweep` last opened."""

from __future__ import annotations

import time

from torch.profiler import record_function

from . import bounds


class _Timed:
    """A callable run inside a named range, adding its bytes per call to
    the spans' current sweep."""

    def __init__(self, spans, key, inner, count):
        self._spans, self._key, self._inner = spans, key, inner
        self._count = count  # (first argument, second argument) -> bytes

    def __call__(self, *args, **kwargs):
        with record_function("bench." + self._key):
            out = self._inner(*args, **kwargs)
        sweep = self._spans.current
        sweep[self._key + "_bytes"] += self._count(*args[:2])
        sweep[self._key + "_calls"] += 1
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _k1(spans, op):
    a, v = bounds.k1_counts(op.pidx, op.n, op.in_keep, op.out_keep)
    return _Timed(spans, "k1", op,
                  lambda A, x: a * A.element_size() + v * x.element_size())


def _km(spans, op):
    p = op.pattern
    vals, idx, vec = bounds.km_counts(p.nnzb, op.d, op.n, op.nodes)
    return _Timed(spans, "km", op,
                  lambda M, x: vals * M.element_size() + idx
                  + vec * x.element_size())


class Spans:
    def __init__(self, solver, device):
        self.device = device
        self.sweeps = []
        self.current = None
        vmg = getattr(solver, "vmg", None)
        if vmg is None:
            return
        setup = vmg.setup

        def timed_setup(*args, **kwargs):
            device.sync()
            t0 = time.perf_counter()
            with record_function("bench.mg_setup"):
                out = setup(*args, **kwargs)
                device.sync()
            self.current["mg_setup_s"].append(time.perf_counter() - t0)
            return out

        vmg.setup = timed_setup
        vmg.patch_solvers = [
            (f, _k1(self, op) if hasattr(op, "pidx") else op)
            for f, op in vmg.patch_solvers]
        for t in vmg.schoeberl or []:
            if hasattr(t.papply, "pidx"):
                t.papply = _k1(self, t.papply)
        vmg.level_ops = [_km(self, op) if hasattr(op, "pattern") else op
                         for op in vmg.level_ops]

    def begin_sweep(self):
        self.current = {"mg_setup_s": [], "k1_bytes": 0, "k1_calls": 0,
                        "km_bytes": 0, "km_calls": 0}
        self.sweeps.append(self.current)
        return self.current
