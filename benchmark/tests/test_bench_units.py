"""The harness's arithmetic on the CPU: the window of whole sweeps, the
percentile, discovery by file name, the K1 and KM byte counts against
hand-counted tables, the trace's reduction on a made-up trace, and the
traffic generator."""

import math
import time

import numpy as np
import pytest
import torch

from benchmark.harness import bounds, registry, stats, traffic
from benchmark.harness.cell import run_window
from benchmark.harness.device import Device
from benchmark.harness.trace import Event, summarize


class FakeSystem:
    """Each step takes ``dt`` seconds and counts one Newton step and two
    Krylov iterations; KSPSolve grows by half the step."""

    def __init__(self, dt):
        self.dt, self.ksp, self.rests = dt, 0.0, 0

    def rest(self):
        self.rests += 1

    def solve(self, re):
        time.sleep(self.dt)
        self.ksp += self.dt / 2
        return (torch.zeros(1), torch.zeros(1),
                {"nonlinear_iter": 1, "linear_iter": 2, "converged": True})

    def events(self):
        return {"KSPSolve": {"time": self.ksp}}


def test_window_runs_whole_sweeps():
    sysm = FakeSystem(0.01)
    sweeps = iter([[1.0, 2.0, 3.0]] * 100)
    out, window_s, prof, states = run_window(sysm, Device("cpu"), sweeps,
                                             0.05)
    # 0.03 s a sweep: the second ends at 0.06 s, past 0.05
    assert len(out) == 2 and sysm.rests == 2 and prof is None
    assert len(states) == 6
    assert window_s >= 0.05
    assert window_s == pytest.approx(sum(s["wall_s"] for s in out),
                                     rel=0.2)
    assert all(len(s["re_s"]) == 3 and s["ksp_s"] == pytest.approx(0.015)
               for s in out)
    record = {"sweeps": out, "window_s": window_s}
    assert registry.reader("sweep_s")(record) == window_s / 2
    assert registry.reader("newton_steps_per_sweep")(record) == 3
    assert registry.reader("krylov_its_per_sweep")(record) == 6


def test_profiled_sweep_traces_its_last_steps():
    from benchmark.harness import trace

    sysm = FakeSystem(0.01)
    sweeps = iter([[1.0, 2.0, 3.0, 4.0, 5.0]] * 100)
    out, _, prof, states = run_window(sysm, Device("cpu"), sweeps, 0.0,
                                      profile_sweep=1)
    assert len(out) == 2 and len(states) == 10
    assert "traced_steps" not in out[0]
    assert out[1]["profiled"] and out[1]["traced_steps"] == [2, 3, 4]
    summary = trace.summarize(trace.events(prof))
    # the traced range holds the three steps, not the whole sweep
    assert 0.03 <= summary["window_s"] < out[1]["wall_s"] - 0.015


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 100) == 100
    assert stats.percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 95) is None
    # over all steps of the timed sweeps, the profiled one left out
    rec = {"sweeps": [{"re_s": [1.0] * 19 + [9.0], "profiled": False},
                      {"re_s": [100.0] * 20, "profiled": True}]}
    assert registry.reader("re_step_p95_s")(rec) == 1.0


def test_span_readers():
    rec = {"sweeps": [
        {"krylov": [2, 3], "ksp_s": 1.0, "mg_setup_s": [0.1, 0.3],
         "profiled": False},
        {"krylov": [5], "ksp_s": 9.0, "mg_setup_s": [9.0],
         "profiled": True}]}
    assert registry.reader("ms_per_krylov_it")(rec) == pytest.approx(120.0)
    assert registry.reader("mg_setup_ms_per_newton")(rec) == \
        pytest.approx(200.0)
    # the idle share: the traced steps' busy time over the same steps' wall
    # time in the unprofiled sweeps, not over the traced span itself
    rec["sweeps"][0]["re_s"] = [9.0, 1.5, 2.5]
    rec["sweeps"][1].update(re_s=[9.0, 3.0, 5.0], traced_steps=[1, 2])
    rec["trace"] = {"busy_s": 1.0, "window_s": 8.0}
    assert registry.reader("device_idle_pct")(rec) == pytest.approx(75.0)
    del rec["sweeps"][0]["mg_setup_s"]
    assert registry.reader("ms_per_krylov_it")(rec) is None


def test_discovery_by_file_name(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["file"] == "benchmark/configs/%s.json" % c["name"]
        # every key that `reduced` names is in the file, with the source's
        # value beside it
        for key in c["reduced"]:
            assert key in cfg and key in cfg["source_values"]
        registry.reference(cfg["reference"]["module"])
    for w in bench["workloads"]:
        traffic.check_mix(registry.traffic(w["traffic"]))
    with pytest.raises(KeyError):
        registry.config("no_such_config")
    with pytest.raises(KeyError):
        registry.reader("no_such_metric")
    with pytest.raises(KeyError):
        registry.reader("no_such_metric.2d")


def test_each_cell_reports_its_own_metrics(bench):
    from benchmark.harness.cell import _metrics
    out, window_s, _, _ = run_window(FakeSystem(0.001), Device("cpu"),
                                     iter([[1.0, 2.0]] * 10), 0.0)
    rec = {"sweeps": out, "window_s": window_s, "peak_bytes": 2e9,
           "trace": None, "setup_s": 3.0}
    d3, d2 = "ldc3d_p1fb_supg.re500", "ldc2d_p2p0.re500"
    # sweep_s holds a bound in the 3D cell alone
    assert set(_metrics(bench, d3, rec, "end_to_end")) == \
        {"sweep_s", "peak_gb", "setup_s"}
    assert set(_metrics(bench, d2, rec, "end_to_end")) == \
        {"peak_gb", "setup_s"}
    p3 = _metrics(bench, d3, rec, "per_layer")
    p2 = _metrics(bench, d2, rec, "per_layer")
    assert not set(p3) & set(p2)
    # the 2D cell reads sweep_s per layer, and the split quantities
    # through their base readers
    assert p2["sweep_wall_s"]["value"] == pytest.approx(out[0]["wall_s"])
    assert p2["krylov_its_per_sweep.2d"] == p3["krylov_its_per_sweep"]
    # every per-layer metric names an end-to-end metric that each of its
    # cells reports
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), m["name"]


def test_readers_find_nothing_in_an_empty_record(bench):
    rec = {"sweeps": [], "window_s": 0.0, "peak_bytes": 0, "trace": None,
           "setup_s": 1.0}
    for m in bench["end_to_end"] + bench["per_layer"]:
        name = m["name"]
        value = registry.reader(name)(rec)
        assert value is None or name == "setup_s", name


def test_k1_counts_hand_counted():
    # two patches over n = 4 dofs; 9 is a pad
    pidx = torch.tensor([[0, 1, 2], [2, 3, 9]])
    # 3 x 3 + 2 x 2 live entries; x gathers {0,1,2,3}, out scatters the same
    assert bounds.k1_counts(pidx, 4) == (13, 8)
    keep = torch.tensor([True, True, True, False])
    # dof 3 passed through: patch 1 keeps 1 row of 2 columns
    assert bounds.k1_counts(pidx, 4, out_keep=keep) == (11, 7)
    keep0 = torch.tensor([False, True, True, True])
    # dof 0 not gathered: patch 0 has 3 rows of 2 columns
    assert bounds.k1_counts(pidx, 4, in_keep=keep0) == (10, 7)


def test_km_counts_hand_counted():
    # 10 blocks of 2 x 2 over 4 nodes (n = 8): 40 values, 10 int32 columns
    # and 5 int32 row pointers, x and out once
    assert bounds.km_counts(10, 2, 8, 4) == (40, 60, 16)
    assert bounds.share_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert bounds.share_pct(0, 1.0) is None
    assert bounds.share_pct(1, 0.0) is None


def _ev(name, dev, s, e, corr=0, link=0):
    return Event(name, dev, s, e, corr, link)


def test_trace_summary_on_a_made_up_trace():
    evs = [
        _ev("bench.traced", False, 0, 1000),
        _ev("bench.k1", False, 40, 60, corr=1),
        _ev("cudaLaunchKernel", False, 50, 55, corr=101),
        _ev("gather_gemv_scatter_kernel", True, 100, 200, corr=101),
        _ev("bench.km", False, 250, 270, corr=2),
        _ev("aten::add", False, 255, 265, corr=3),
        _ev("level_apply_kernel", True, 300, 350, corr=999, link=3),
        _ev("cudaLaunchKernel", False, 280, 285, corr=102),
        _ev("elementwise_kernel", True, 320, 400, corr=102),
        _ev("aten::item", False, 500, 900, corr=4),
        # the host ranges mirrored on the device's timeline
        _ev("bench.traced", True, 0, 1000, corr=5),
        _ev("bench.k1", True, 100, 200, corr=1),
    ]
    s = summarize(evs)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(200e-9)
    assert s["ranges"]["k1"]["device_s"] == pytest.approx(100e-9)
    assert s["ranges"]["km"]["device_s"] == pytest.approx(50e-9)
    assert s["ranges"]["km"]["kernels"] == 1
    assert s["linked_events"] == 3
    assert s["device_ops"][0] == ["gather_gemv_scatter_kernel",
                                  pytest.approx(100e-9)]
    gaps = dict(s["idle_gaps"])
    # gaps [0, 100], [200, 300] and [400, 1000]: their middles lie in
    # bench.k1, bench.km (the runtime call is not a host op) and aten::item
    assert gaps["bench.k1"] == pytest.approx(100e-9)
    assert gaps["aten::item"] == pytest.approx(600e-9)
    assert gaps["bench.km"] == pytest.approx(100e-9)
    assert sum(gaps.values()) == pytest.approx(800e-9)
    assert summarize([e for e in evs if e.name != "bench.traced"]) is None


def test_traffic_is_drawn_from_the_seed():
    mix = registry.traffic("ladder_re500")
    a = traffic.sweeps(mix, 2 ** 40 + 7)
    b = traffic.sweeps(mix, 2 ** 40 + 7)
    first = [next(a) for _ in range(3)]
    assert first == [next(b) for _ in range(3)]
    assert first[0] != first[1]
    for sweep in first:
        assert sweep[0] == 1.0
        for r, base in zip(sweep[1:], mix["rungs"][1:]):
            assert abs(r / base - 1.0) <= mix["jitter"]
    assert next(traffic.sweeps(mix, -5)) != first[0]
    with pytest.raises(ValueError):
        traffic.check_mix(dict(mix, rungs=[1, 100, 10]))


def test_gauss_jacobi_rules_are_exact():
    ref = registry.reference("ns_pkp0")
    for dim, deg in ((2, 5), (3, 8)):
        lam, w = ref.simplex_rule(dim, deg)
        x = lam[:, 1:]
        for e in [(0, 0, 0), (2, 1, 0), (3, 2, 3), (0, 5, 0), (4, 0, 1)]:
            e = e[:dim]
            if sum(e) > deg:
                continue
            exact = (np.prod([math.factorial(k) for k in e])
                     / math.factorial(sum(e) + dim))
            got = (w * np.prod(x ** np.array(e), axis=1)).sum()
            assert got == pytest.approx(exact, rel=1e-13), (dim, e)


@pytest.mark.parametrize("dim,degree,bubbles",
                         [(2, 2, False), (3, 2, False), (3, 2, True),
                          (3, 1, True)])
def test_nodal_basis(dim, degree, bubbles):
    ref = registry.reference("ns_pkp0")
    ents = ref.local_entities(dim, degree, bubbles)
    nodes = np.zeros((len(ents), dim + 1))
    for n, ent in enumerate(ents):
        nodes[n, list(ent)] = 1.0 / len(ent)
    val, d1, d2 = ref.nodal_basis(dim, degree, bubbles, nodes)
    assert np.allclose(val, np.eye(len(ents)), atol=1e-13)
    lam, _ = ref.simplex_rule(dim, 4)
    val, d1, d2 = ref.nodal_basis(dim, degree, bubbles, lam)
    # a partition of unity: its barycentric derivatives are the same along
    # every lambda, so that its physical gradient and hessian vanish
    assert np.allclose(val.sum(1), 1.0, atol=1e-13)
    g, h = d1.sum(1), d2.sum(1)
    assert np.allclose(g, g[:, :1], atol=1e-12)
    assert np.allclose(h, h[:, :1, :1], atol=1e-11)
