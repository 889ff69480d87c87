"""The program's own spans in the device trace.

alfi_torch marks its layers with ``torch.profiler.record_function`` ranges
named ``alfi.*`` whenever a profiler records (``alfi_torch/utils/events.py``:
``alfi.re_step``, ``alfi.linear_step``, ``alfi.pc_apply``, ``alfi.smooth``,
``alfi.mg_setup.patch_inverse``, ...).  :func:`reduce` takes the traced
steps' events as :func:`trace.events` makes them and gives, for each span
name, over the ``bench.traced`` window:

* ``calls``: the ranges of that name;
* ``device_s``: self device seconds, the kernels, copies and sets whose
  launch falls in a range of that name and in none of its children (a
  device operation is tied to its launch by the correlation id, as in
  :func:`trace.summarize`);
* ``launches``: self runtime calls that put work on a stream
  (``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaMemcpy*Async``,
  ``cudaMemset*Async``);
* ``syncs``: self runtime calls that wait for the device
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``, the synchronous ``cudaMemcpy``);
* ``idle_s``: self idle seconds, each gap between the device's busy
  intervals going to the innermost range open at its middle;

and the same four with the children included (``*_incl``; a range inside
one of its own name counts once).  The row ``unspanned`` holds what falls
in no range.  One sweep in time order, O(n log n); no host-op scan, no
limit on how far back a range opened.
"""

from __future__ import annotations

import bisect

from .trace import _RUNTIME_PREFIX, _union

PREFIX = "alfi."
UNSPANNED = "unspanned"
QUANTITIES = ("device_s", "launches", "syncs", "idle_s")


def _launches(name):
    """A runtime call that puts work on a stream."""
    return (name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
            or (name.startswith(("cudaMemcpy", "cudaMemset"))
                and "Async" in name))


def _syncs(name):
    """A runtime call that waits for the device."""
    return (name.startswith(("cudaStreamSynchronize",
                             "cudaDeviceSynchronize",
                             "cudaEventSynchronize"))
            or (name.startswith("cudaMemcpy") and "Async" not in name))


class _Nested:
    """Nested host intervals [(start, end, name)], sorted by (start,
    -end): each one's parent and whether one of its own name encloses it,
    and the innermost one open at a time."""

    def __init__(self, intervals):
        self.iv = sorted(intervals, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.iv]
        self.parent = [-1] * len(self.iv)
        self.inside_own = [False] * len(self.iv)
        stack, open_names = [], {}
        for i, (_, end, name) in enumerate(self.iv):
            while stack and self.iv[stack[-1]][1] < end:
                j = stack.pop()
                open_names[self.iv[j][2]] -= 1
            if stack:
                self.parent[i] = stack[-1]
            self.inside_own[i] = open_names.get(name, 0) > 0
            open_names[name] = open_names.get(name, 0) + 1
            stack.append(i)

    def owner(self, t):
        """The index of the innermost interval open at ``t``, or -1."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.iv[j][1] < t:
            j = self.parent[j]
        return j


def reduce(evs, window="bench.traced", prefix=PREFIX):
    """The per-span reduction (see the module docstring), or None without
    the window range: {"rows": {name: {calls, device_s, launches, syncs,
    idle_s, and each ``_incl``}}, "device_s": every linked device
    operation's seconds, "idle_s": the window's idle seconds, "unlinked":
    device operations with no launch found, "window_s"}."""
    wins = [e for e in evs if not e.on_device and e.name == window]
    if not wins:
        return None
    lo, hi = wins[0].start, wins[0].end
    host_names = {e.name for e in evs if not e.on_device}
    dev = [e for e in evs if e.on_device and e.name not in host_names
           and e.end > lo and e.start < hi]
    runtime = [e for e in evs if not e.on_device
               and e.name.startswith(_RUNTIME_PREFIX)]
    launch_at = {e.corr: e.start for e in runtime}
    ops = {e.corr: e.start for e in evs if not e.on_device
           and not e.name.startswith(_RUNTIME_PREFIX)}

    nest = _Nested((e.start, e.end, e.name) for e in evs
                   if not e.on_device and e.name.startswith(prefix))
    spans, parent = nest.iv, nest.parent
    n = len(spans)
    # per span instance, and the last slot (-1) for the unspanned
    self_q = {q: [0] * (n + 1) for q in QUANTITIES}
    owner = nest.owner

    linked_ns, unlinked = 0, 0
    for e in dev:
        t = launch_at.get(e.corr, ops.get(e.link))
        if t is None:
            unlinked += 1
            continue
        self_q["device_s"][owner(t)] += e.end - e.start
        linked_ns += e.end - e.start
    for e in runtime:
        if not lo <= e.start <= hi:
            continue
        if _launches(e.name):
            self_q["launches"][owner(e.start)] += 1
        elif _syncs(e.name):
            self_q["syncs"][owner(e.start)] += 1
    merged = _union([(e.start, e.end) for e in dev], lo, hi)
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    idle_ns = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            self_q["idle_s"][owner(0.5 * (a + b))] += b - a
            idle_ns += b - a

    # children's totals into their parents, innermost first
    incl_q = {q: list(v) for q, v in self_q.items()}
    for i in range(n - 1, -1, -1):
        if parent[i] >= 0:
            for q in QUANTITIES:
                incl_q[q][parent[i]] += incl_q[q][i]

    rows = {}

    def row(name):
        if name not in rows:
            rows[name] = dict({"calls": 0},
                              **{k: 0 for q in QUANTITIES
                                 for k in (q, q + "_incl")})
        return rows[name]

    for i, (_, _, name) in enumerate(spans):
        r = row(name)
        r["calls"] += 1
        for q in QUANTITIES:
            r[q] += self_q[q][i]
            if not nest.inside_own[i]:
                r[q + "_incl"] += incl_q[q][i]
    r = row(UNSPANNED)
    for q in QUANTITIES:
        r[q] = r[q + "_incl"] = self_q[q][-1]
    for r in rows.values():
        for q in ("device_s", "idle_s"):
            r[q] /= 1e9
            r[q + "_incl"] /= 1e9
    return {"rows": rows, "device_s": linked_ns / 1e9,
            "idle_s": idle_ns / 1e9, "unlinked": unlinked,
            "window_s": (hi - lo) / 1e9}


def sync_sites(evs, window="bench.traced", prefix=PREFIX, top=20):
    """[[span, host op, syncs]] of the window's synchronising runtime
    calls, by the innermost program span and the innermost host op (no
    span, no benchmark range) open at each call, most first: where the
    program waits for the device without a counted host read."""
    wins = [e for e in evs if not e.on_device and e.name == window]
    if not wins:
        return None
    lo, hi = wins[0].start, wins[0].end
    spans = _Nested((e.start, e.end, e.name) for e in evs
                    if not e.on_device and e.name.startswith(prefix))
    ops = _Nested((e.start, e.end, e.name) for e in evs
                  if not e.on_device
                  and not e.name.startswith((_RUNTIME_PREFIX, prefix,
                                             "bench.")))
    sites = {}
    for e in evs:
        if (e.on_device or not e.name.startswith(_RUNTIME_PREFIX)
                or not _syncs(e.name) or not lo <= e.start <= hi):
            continue
        i, j = spans.owner(e.start), ops.owner(e.start)
        key = (spans.iv[i][2] if i >= 0 else UNSPANNED,
               ops.iv[j][2] if j >= 0 else "(no host op)")
        sites[key] = sites.get(key, 0) + 1
    return [[s, o, c] for (s, o), c in
            sorted(sites.items(), key=lambda kv: -kv[1])[:top]]


def table(red):
    """The reduction as text lines, by self device time, ``unspanned``
    last."""
    head = ("%-30s %7s %10s %10s %9s %7s %9s %10s"
            % ("span", "calls", "device_s", "incl_s", "launches", "syncs",
               "idle_s", "incl_launch"))
    names = sorted((k for k in red["rows"] if k != UNSPANNED),
                   key=lambda k: -red["rows"][k]["device_s"]) + [UNSPANNED]
    lines = [head]
    for k in names:
        r = red["rows"][k]
        lines.append("%-30s %7d %10.4f %10.4f %9d %7d %9.4f %10d"
                     % (k, r["calls"], r["device_s"], r["device_s_incl"],
                        r["launches"], r["syncs"], r["idle_s"],
                        r["launches_incl"]))
    lines.append("device %.4f s linked (%d unlinked), idle %.4f s of a "
                 "%.4f s window" % (red["device_s"], red["unlinked"],
                                    red["idle_s"], red["window_s"]))
    return lines


def traced_counts(record):
    """(Krylov its, Newton steps) of the profiled sweep's traced steps, or
    None without a profiled sweep."""
    prof = [s for s in record["sweeps"] if s["profiled"]]
    if not prof:
        return None
    steps = prof[0]["traced_steps"]
    return (sum(prof[0]["krylov"][i] for i in steps),
            sum(prof[0]["newton"][i] for i in steps))


def span_row(record, name):
    """The reduction's row of span ``name`` in the run's record, or None
    where the run has no reduction or the program no such span."""
    red = record.get("spans")
    if not red:
        return None
    r = red["rows"].get(name)
    return r if r and r["calls"] else None
