"""Reading the device trace of the profiled sweep's traced steps.

``torch.profiler`` records the last steps of one sweep (CPU ops, the
benchmark's ranges and the card's kernels, copies and sets).  :func:`events` turns its kineto
events into plain tuples; :func:`summarize` reduces them, with no torch
involved, to what the per-layer metrics read:

* ``window_s``: the traced steps' span (the ``bench.traced`` range);
* ``busy_s``: the union of the device operations' intervals inside it;
* per benchmark range (``bench.k1``, ``bench.km``): the device seconds of
  the kernels launched inside it, a kernel being matched to the CPU op
  that launched it by the profiler's correlation id;
* ``device_ops``: the device operations that took most time, by name;
* ``idle_gaps``: the device's idle time inside the window, by the host op
  that was running at each gap's middle (the innermost one; Python
  between ops shows as "host outside any profiled op").
"""

from __future__ import annotations

import bisect
from collections import namedtuple

#: one trace event: on_device, its times in ns, its correlation id and,
#: for a device event, the id of the CPU op that launched it
Event = namedtuple("Event", "name on_device start end corr link")

#: host events named so are calls into CUDA (cudaLaunchKernel,
#: cuLaunchKernel, ...), not what the host was doing
_RUNTIME_PREFIX = "cu"


def events(prof):
    """The profiler's events as :class:`Event` tuples."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(e.name(), e.device_type() == cuda, start,
                         start + e.duration_ns(), e.correlation_id(),
                         e.linked_correlation_id()))
    return out


def _union(intervals, lo, hi):
    """Merged (start, end) intervals, clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _is_host_op(name):
    return not name.startswith(_RUNTIME_PREFIX)


def summarize(evs, ranges=("k1", "km"), window="bench.traced", top=10):
    """The trace's reduction (see the module docstring), or None without
    the window range.  Every number in seconds."""
    wins = [e for e in evs if not e.on_device and e.name == window]
    if not wins:
        return None
    lo, hi = wins[0].start, wins[0].end
    # the profiler mirrors each host range onto the device's timeline
    # under the range's name: that is no device operation
    host_names = {e.name for e in evs if not e.on_device}
    dev = [e for e in evs if e.on_device and e.name not in host_names
           and e.end > lo and e.start < hi]
    host = sorted((e for e in evs if not e.on_device and e.name != window
                   and _is_host_op(e.name)), key=lambda e: e.start)
    merged = _union([(e.start, e.end) for e in dev], lo, hi)
    busy = sum(e - s for s, e in merged)

    # each device event's launch time: its runtime call (same correlation
    # id), else the host op the profiler links it to
    runtime = {e.corr: e.start for e in evs
               if not e.on_device and not _is_host_op(e.name)}
    ops = {e.corr: e.start for e in host}
    launched = [runtime.get(e.corr, ops.get(e.link)) for e in dev]
    found = {}
    for key in ranges:
        spans = sorted((e.start, e.end) for e in host
                       if e.name == "bench." + key)
        starts = [s for s, _ in spans]
        total, n = 0, 0
        for e, t in zip(dev, launched):
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                total += e.end - e.start
                n += 1
        found[key] = {"device_s": total / 1e9, "kernels": n,
                      "ranges": len(spans)}
    linked = sum(1 for t in launched if t is not None)

    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0) + (e.end - e.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # idle gaps, named by the innermost host op running at their middle
    hstart = [e.start for e in host]
    gaps = {}
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host outside any profiled op"
        j = bisect.bisect_right(hstart, mid) - 1
        for k in range(j, max(j - 256, -1), -1):
            if host[k].end >= mid:
                name = host[k].name
                break
        gaps[name] = gaps.get(name, 0) + (b - a)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "ranges": found, "device_events": len(dev),
            "linked_events": linked,
            "device_ops": [[n, t / 1e9] for n, t in device_ops],
            "idle_gaps": [[n, t / 1e9] for n, t in idle]}
