"""sweep_wall_s: the mean host seconds of the window's sweeps that ran
without the profiler, each from rest to the ladder's top Reynolds number.
It is ``sweep_s`` read as a per-layer metric, for a cell whose sweeps the
host paces, so that a shared host's speed spreads them too widely to hold
a bound."""

from benchmark.harness.stats import timed_sweeps


def read(record):
    walls = [s["wall_s"] for s in timed_sweeps(record)]
    return sum(walls) / len(walls) if walls else None
