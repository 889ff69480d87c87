"""The program's spans of one cell on the card: what a ``--trace 1`` run
sees, reduced per span.

    python3 benchmark/profile_spans.py --workload <cell> --seed <n> \\
        [--count-entries] [--out spans.json]

In one process: the cell's set-up (``cell.build``), then the window of a
``--trace 1`` run cut to its two sweeps (the benchmark's ``bench.*`` spans
on, the second sweep's last steps under ``torch.profiler``), with the
program's counted host reads (``alfi_torch.utils.events.COUNTERS``) taken
per sweep.  The traced steps' events are reduced by ``trace.summarize``
and by ``harness/program_spans.py``.  Printed on standard error: the
``spans:`` table (self device seconds, launches, synchronisations and
idle seconds per span, and the ``unspanned`` row) and the
synchronisations by span and host op; on standard output, as the last
line, one JSON object: every per-layer metric of ``BENCHMARK.json`` and
the readers in ``metrics/`` that read the reduction and the counter,
computed from this record, and the reduction's own seconds.  With
``--count-entries`` one more sweep counts the spans the program enters
(every span opened as a profiler would, into a shared no-op) and the
host's cost of one span with no profiler recording.

It needs a card, as run.py does, and is not run by the benchmark's runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

#: the metrics this record adds to what a traced run's record holds
SPAN_METRICS = ("cycle_launches_per_krylov_it", "host_syncs_per_krylov_it",
                "smoother_gs_ms_per_krylov_it",
                "patch_inverse_ms_per_newton")


def profile(system, dev, sweeps):
    """The record of a traced run's window, cut to its two sweeps, with
    ``spans`` (the program's spans reduced) and each sweep's
    ``host_reads``; and the benchmark's spans object."""
    from alfi_torch.utils.events import COUNTERS
    from benchmark.harness import program_spans, trace
    from benchmark.harness.cell import run_window
    from benchmark.harness.spans import Spans

    reads = []
    solve = system.solve

    def counted(re):
        n0 = COUNTERS["host_reads"]
        out = solve(re)
        reads.append(COUNTERS["host_reads"] - n0)
        return out

    system.solve = counted
    spans = Spans(system.solver, dev)
    try:
        rec, window_s, prof, _ = run_window(system, dev, sweeps, 0.0,
                                            spans=spans, profile_sweep=1)
    finally:
        system.solve = solve
    k = 0
    for sw in rec:
        sw["host_reads"] = sum(reads[k:k + len(sw["re"])])
        k += len(sw["re"])
    t0 = time.perf_counter()
    evs = trace.events(prof)
    del prof
    summary = trace.summarize(evs)
    red = program_spans.reduce(evs)
    reduce_s = time.perf_counter() - t0
    record = {"window_s": window_s, "sweeps": rec, "trace": summary,
              "spans": red, "reduce_s": reduce_s, "events": len(evs),
              "sync_sites": program_spans.sync_sites(evs)}
    return record, spans


def count_entries(system, spans, res):
    """{span name: entries} of one sweep ``res`` from rest, every span
    opened as under a profiler, into a shared no-op."""
    from contextlib import nullcontext

    from alfi_torch.utils import events

    counts = {}
    off = nullcontext()

    def opener(name):
        counts[name] = counts.get(name, 0) + 1
        return off

    saved = events._profiler_enabled, events._record_function
    events._profiler_enabled, events._record_function = (lambda: True,
                                                         opener)
    spans.begin_sweep()
    try:
        system.rest()
        for re in res:
            system.solve(re)
    finally:
        events._profiler_enabled, events._record_function = saved
    return counts


def span_cost_ns(n=1_000_000):
    """Host ns of one span entry with no profiler recording: the context
    form and the decorator form, each less its bare loop."""
    from alfi_torch.utils import events

    def bare():
        return None

    wrapped = events.spanned("alfi.cost")(bare)
    ctx = timeit.timeit('with span("alfi.cost"): pass',
                        globals={"span": events.span}, number=n)
    empty = timeit.timeit("pass", number=n)
    deco = timeit.timeit(wrapped, number=n)
    plain = timeit.timeit(bare, number=n)
    return {"span_ns": 1e9 * (ctx - empty) / n,
            "spanned_ns": 1e9 * (deco - plain) / n}


def metrics(bench, record):
    """{name: value} of every per-layer metric of ``bench`` and of
    SPAN_METRICS that the record has something for."""
    from benchmark.harness import registry

    names = [m["name"] for m in bench["per_layer"]]
    names += [n for n in SPAN_METRICS if n not in names]
    out = {}
    for name in names:
        v = registry.reader(name)(record)
        if v is not None:
            out[name] = v
    return out


def run(workload, seed, device="cuda", count=False, config=None, mix=None):
    """One profile of ``workload`` (``config``/``mix``: given dicts instead
    of the cell's files); returns the result object."""
    from benchmark.harness import program_spans, registry, traffic
    from benchmark.harness.cell import build, free
    from benchmark.harness.device import Device

    bench = registry.load_benchmark()
    w = registry.workload(bench, workload)
    config = config or registry.config(w["config"])
    mix = mix or registry.traffic(w["traffic"])
    dev = Device(device)
    system, _, _ = build(config, mix, device, T_START)
    sweeps = traffic.sweeps(mix, seed)
    record, spans = profile(system, dev, sweeps)
    red = record["spans"]
    if red is not None:
        print("spans:", file=sys.stderr)
        for line in program_spans.table(red):
            print("  " + line, file=sys.stderr)
        print("synchronisations by span and host op:", file=sys.stderr)
        for site in record["sync_sites"]:
            print("  %-30s %-40s %7d" % tuple(site), file=sys.stderr)
    result = {"workload": workload, "seed": seed,
              "metrics": metrics(bench, record),
              "traced": program_spans.traced_counts(record),
              "sweeps": [{k: s[k] for k in ("re_s", "krylov", "newton",
                                            "wall_s", "host_reads")}
                         for s in record["sweeps"]],
              "reduce_s": record["reduce_s"], "events": record["events"],
              "sync_sites": record["sync_sites"],
              "spans": red,
              "idle_gaps": (record["trace"] or {}).get("idle_gaps"),
              "busy_s": (record["trace"] or {}).get("busy_s")}
    if count:
        t0 = time.perf_counter()
        result["entries"] = count_entries(system, spans, next(sweeps))
        result["entries_sweep_s"] = time.perf_counter() - t0
        result["cost"] = span_cost_ns()
    free(system, dev)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--count-entries", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    import torch

    from benchmark.harness import device, registry

    w = registry.workload(registry.load_benchmark(), a.workload)
    device.require_cards(int(w["chips"]))
    print("card: %s (nvidia-smi: %s); torch %s"
          % (torch.cuda.get_device_name(0), device.power_limit(),
             torch.__version__), file=sys.stderr, flush=True)
    result = run(a.workload, a.seed, count=a.count_entries)
    result["card"] = torch.cuda.get_device_name(0)
    result["power"] = device.power_limit()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "spans"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
