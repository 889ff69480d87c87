"""The one traffic generator: Reynolds-continuation sweeps.

A mix (``traffic/<name>.json``) gives the ladder's ``rungs``, the
half-width ``jitter`` of the uniform relative draw that moves each rung
above ``fixed_up_to`` (``Re (1 + delta)``) and the Reynolds number of the
set-up's warm-up solve (``warmup_re``).  Every sweep starts from rest (the
Dirichlet data, zero elsewhere), and the loop is closed: one sweep at a
time, each rung after the last has returned.  The seed draws the deltas
and nothing else."""

from __future__ import annotations

import numpy as np


def check_mix(mix):
    rungs = [float(r) for r in mix["rungs"]]
    if not rungs or min(rungs) <= 0 or rungs != sorted(rungs):
        raise ValueError("rungs must be positive and ascending")
    if not 0.0 <= float(mix["jitter"]) < 0.5:
        raise ValueError("jitter must lie in [0, 0.5)")
    return rungs


def sweeps(mix, seed):
    """The sweeps of ``seed``, without end: each a list of Reynolds
    numbers."""
    rungs = check_mix(mix)
    jitter, fixed = float(mix["jitter"]), float(mix["fixed_up_to"])
    rng = np.random.Generator(np.random.PCG64(int(seed) % 2 ** 64))
    while True:
        delta = rng.uniform(-jitter, jitter, size=len(rungs))
        yield [r if r <= fixed else r * (1.0 + float(dl))
               for r, dl in zip(rungs, delta)]
