"""Arithmetic the metric readers share."""

from __future__ import annotations

import math

from .bounds import share_pct


def timed_sweeps(record):
    """The sweeps whose host times stand: all but the profiled one."""
    return [s for s in record["sweeps"] if not s["profiled"]]


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least q % of them at or below it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def per_sweep(record, key):
    """The sum of ``key`` over every step of the window, per sweep."""
    sweeps = record["sweeps"]
    if not sweeps:
        return None
    return sum(sum(s[key]) for s in sweeps) / len(sweeps)


def range_share(record, key):
    """The share (%) of the bandwidth bound of the kernels launched under
    the range ``bench.<key>`` in the profiled sweep, or None."""
    tr = record.get("trace")
    prof = [s for s in record["sweeps"] if s["profiled"]]
    if not tr or not prof or key not in tr["ranges"]:
        return None
    return share_pct(prof[0].get(key + "_bytes", 0),
                     tr["ranges"][key]["device_s"])
