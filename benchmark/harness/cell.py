"""One run of one cell: set-up, the measured window of whole continuation
sweeps, the traced sweep, the check, and the result line.

Set-up: import, the kernel library built or loaded from its cache in the
checkout, the solver built by the program's get_solver, one warm-up solve at
the mix's ``warmup_re`` from rest, and the state reset.  The window then
runs whole sweeps (rest, then ``solve(re)`` for each rung) and ends with
the first sweep that finishes at or after ``seconds``.  With ``trace`` the
last steps of the window's second sweep run under ``torch.profiler`` and
the spans of ``spans.py`` are on for the whole window.

The run's record, which every metric reader reads:

``setup_s``, ``window_s``, ``peak_bytes`` (allocated on the device over
the window, from a reset at its start), ``sweeps``: per sweep ``re``,
``re_s`` (host seconds of each step), ``newton``, ``krylov``,
``converged``, ``wall_s``, ``ksp_s`` (the program's ``KSPSolve`` event
over the sweep), ``profiled`` (and in the profiled sweep ``traced_steps``,
the indices of the steps under the profiler); in a traced run also
``mg_setup_s`` (per multigrid set-up call), ``k1_bytes``, ``km_bytes`` and
their ``_calls`` (in the profiled sweep: of its traced steps); ``trace``:
``trace.summarize``'s reduction of the traced steps, or None.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from . import check, registry, trace as trace_mod, traffic
from .device import Device
from .spans import Spans
from .system import System


def _ksp_seconds(system):
    return float(system.events()["KSPSolve"]["time"])


#: the steps at the top of the profiled sweep's ladder that run under the
#: profiler: reducing a whole 3D sweep's trace (about six million events)
#: takes minutes and would end a traced run near its time limit
TRACED_STEPS = 3


def _steps(system, res, sw, states):
    for re in res:
        t = time.perf_counter()
        u, p, info = system.solve(re)
        sw["re_s"].append(time.perf_counter() - t)
        sw["newton"].append(int(info["nonlinear_iter"]))
        sw["krylov"].append(int(info["linear_iter"]))
        sw["converged"].append(bool(info["converged"]))
        states.append((re, u, p))


def run_window(system, device, sweeps, seconds, *, spans=None,
               profile_sweep=None):
    """Whole sweeps until one ends at or after ``seconds`` (and, with
    ``profile_sweep``, until that sweep has run; its last ``TRACED_STEPS``
    steps run under the profiler, inside the range ``bench.traced``, and
    the spans' counters of that sweep cover those steps alone).  Returns
    the record's ``sweeps``, the window's seconds, the profiler of the
    profiled sweep (or None) and the steps' states [(re, u, p)]."""
    out, states, evs = [], [], None
    t0 = time.perf_counter()
    while True:
        res = next(sweeps)
        k = len(out)
        sw = {"re": res, "re_s": [], "newton": [], "krylov": [],
              "converged": [], "profiled": k == profile_sweep}
        cut = max(0, len(res) - TRACED_STEPS) if sw["profiled"] else len(res)
        if sw["profiled"]:
            sw["traced_steps"] = list(range(cut, len(res)))
        if spans is not None:
            spans.begin_sweep()
        prof = None
        ksp0 = _ksp_seconds(system)
        ts = time.perf_counter()
        system.rest()
        _steps(system, res[:cut], sw, states)
        if sw["profiled"]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            device.sync()
            if spans is not None:
                spans.begin_sweep()
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            with torch.profiler.record_function("bench.traced"):
                _steps(system, res[cut:], sw, states)
                device.sync()
        device.sync()
        sw["wall_s"] = time.perf_counter() - ts
        sw["ksp_s"] = _ksp_seconds(system) - ksp0
        if prof is not None:
            prof.stop()
            evs = prof
        if spans is not None:
            sw.update(spans.current)
        out.append(sw)
        print("sweep %d: %.3f s, Krylov %s, Newton %s%s"
              % (k, sw["wall_s"], sw["krylov"], sw["newton"],
                 " (profiled)" if sw["profiled"] else ""),
              file=sys.stderr, flush=True)
        if (time.perf_counter() - t0 >= seconds
                and (profile_sweep is None or k >= profile_sweep)):
            return out, time.perf_counter() - t0, evs, states


def _metrics(bench, workload, record, section):
    """{name: {value, unit}} of the cell's metrics of ``section``
    (``end_to_end`` or ``per_layer``), each from its reader; a reader
    that finds nothing leaves its metric out."""
    out = {}
    for m in bench[section]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = registry.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def build(config, mix, device, t_start, system_hook=None):
    """Set-up up to the window: the system of ``config`` built on
    ``device``, warmed up by one solve at the mix's ``warmup_re`` from rest
    and reset to rest.  Returns (system, its finest mesh, its nodes: the
    velocity and pressure dof coordinates and the pressure's cell-to-dof
    map).  ``system_hook(system)`` runs on the built system before
    the warm-up (the tests break it there)."""
    t_import = time.perf_counter()
    system = System(config, device)
    if system_hook is not None:
        system_hook(system)
    mesh = system.mesh()
    nodes = system.node_coords() + (system.pressure_cell_dofs(),)
    t_built = time.perf_counter()
    system.rest()
    system.solve(float(mix["warmup_re"]))
    system.rest()
    print("set-up: %.3f s to the solver's build, %.3f s to build it, "
          "%.3f s to warm up" % (t_import - t_start, t_built - t_import,
                                 time.perf_counter() - t_built),
          file=sys.stderr, flush=True)
    return system, mesh, nodes


def free(system, dev):
    """Drop the program's state from the device, before the reference
    runs there."""
    system.close()
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()


def run(bench, workload, seed, seconds, trace, *, t_start, device="cuda",
        config=None, mix=None, system_hook=None):
    """One run; returns the result line's object.  ``config``/``mix``:
    given dicts instead of the cell's files; ``system_hook``: see
    :func:`build`."""
    w = registry.workload(bench, workload)
    config = config or registry.config(w["config"])
    mix = mix or registry.traffic(w["traffic"])
    dev = Device(device)
    system, mesh, nodes = build(config, mix, device, t_start, system_hook)
    spans = Spans(system.solver, dev) if trace else None
    sweeps = traffic.sweeps(mix, seed)
    dev.sync()
    setup_peak = dev.peak_bytes()
    dev.reset_peak()
    setup_s = time.perf_counter() - t_start

    sweep_rec, window_s, prof, states = run_window(
        system, dev, sweeps, seconds, spans=spans,
        profile_sweep=1 if trace else None)
    dev.sync()
    peak = dev.peak_bytes()
    summary = None
    if prof is not None:
        summary = trace_mod.summarize(trace_mod.events(prof))
        del prof
        if summary is not None:
            print("trace: %d device events, %d matched to their launch; "
                  "ranges %s" % (summary["device_events"],
                                 summary["linked_events"], summary["ranges"]),
                  file=sys.stderr)
    record = {"setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
              "sweeps": sweep_rec, "trace": summary}

    # the program's state goes before the reference runs on the device
    del spans
    free(system, dev)
    del system
    correct, numbers, residuals = check.judge(config, mesh, nodes, states,
                                              device=device)
    limit = numbers["residual_max"]["limit"]
    converged = [c for s in sweep_rec for c in s["converged"]]
    failed = sum(1 for i, c in enumerate(converged)
                 if not c or i >= len(residuals) or residuals[i] > limit)

    section = "per_layer" if trace else "end_to_end"
    desc = dev.describe(int(w["chips"]))
    desc["memory_peak_bytes"] = max(setup_peak, peak)
    if trace and summary is not None:
        desc["busy_s"] = summary["busy_s"]
        desc["window_s"] = summary["window_s"]
    result = {"correct": bool(correct), "attempted": len(states),
              "failed": failed,
              "metrics": _metrics(bench, workload, record, section),
              "device": desc}
    if trace and summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    check.print_numbers(numbers)
    result["check"] = numbers
    return result
