"""The reduction of the program's own spans (``harness/program_spans.py``)
on a synthetic trace, ``trace.summarize`` unchanged by those spans, and
``profile_spans.py``'s traced run on the CPU at ldc2d baseN 4, nref 1."""

import time

import pytest
import torch

from benchmark import profile_spans
from benchmark.harness import program_spans, trace
from conftest import CELL

E = trace.Event


def _host(name, start, end, corr=0):
    return E(name, False, start, end, corr, 0)


def _dev(name, start, end, corr, link=0):
    return E(name, True, start, end, corr, link)


BASE = [
    _host("bench.traced", 0, 1000),
    _host("bench.k1", 265, 330),
    # runtime calls, by their launch times
    _host("cudaLaunchKernel", 270, 272, corr=1),
    _host("cudaLaunchKernel", 320, 322, corr=2),
    _host("cudaMemcpyAsync", 450, 451, corr=3),
    _host("aten::_local_scalar_dense", 454, 462),
    _host("cudaStreamSynchronize", 455, 461),
    _host("cuLaunchKernel", 620, 621, corr=4),
    _host("cudaMemcpy", 870, 871),
    _host("cudaDeviceSynchronize", 950, 951),
    # outside the window: not counted
    _host("cudaLaunchKernel", 1100, 1101, corr=50),
    # a host op whose device operation has no runtime call of its own
    _host("aten::mm", 150, 160, corr=10),
    _dev("kernel_a", 300, 340, corr=1),
    _dev("kernel_b", 340, 400, corr=2),
    _dev("Memcpy DtoD", 450, 460, corr=3),
    _dev("kernel_c", 640, 680, corr=4),
    _dev("kernel_mm", 150, 200, corr=99, link=10),
    # launched by nothing the trace holds
    _dev("kernel_lost", 900, 910, corr=77, link=88),
]

SPANS = [
    _host("alfi.re_step", 10, 900),
    _host("alfi.linear_step", 100, 800),
    _host("alfi.pc_apply", 200, 500),
    _host("alfi.smooth", 250, 400),
    _host("alfi.level_apply", 260, 300),
    _host("alfi.level_apply", 270, 290),
    _host("alfi.pc_apply", 550, 750),
    _host("alfi.smooth", 600, 700),
    # the profiler's mirror of a host range on the device's timeline
    _dev("alfi.pc_apply", 200, 500, corr=0),
]


def test_reduce_nesting_self_and_inclusive():
    red = program_spans.reduce(BASE + SPANS)
    rows = red["rows"]
    assert {k: r["calls"] for k, r in rows.items()} == {
        "alfi.re_step": 1, "alfi.linear_step": 1, "alfi.pc_apply": 2,
        "alfi.smooth": 2, "alfi.level_apply": 2,
        program_spans.UNSPANNED: 0}

    def ns(name, key):
        return round(rows[name][key] * 1e9)

    # self device time: by the innermost range open at each launch
    assert ns("alfi.level_apply", "device_s") == 40
    assert ns("alfi.smooth", "device_s") == 60 + 40
    assert ns("alfi.pc_apply", "device_s") == 10
    assert ns("alfi.linear_step", "device_s") == 50  # linked by its host op
    assert ns("alfi.re_step", "device_s") == 0
    assert ns(program_spans.UNSPANNED, "device_s") == 0
    # children included; a range inside one of its own name counts once
    assert ns("alfi.level_apply", "device_s_incl") == 40
    assert ns("alfi.smooth", "device_s_incl") == 140
    assert ns("alfi.pc_apply", "device_s_incl") == 150
    assert ns("alfi.re_step", "device_s_incl") == 200
    assert round(red["device_s"] * 1e9) == 200
    assert red["unlinked"] == 1
    assert round(sum(r["device_s"] for r in rows.values()) * 1e9) == 200
    # launches and synchronisations
    assert {k: r["launches"] for k, r in rows.items() if r["launches"]} == {
        "alfi.level_apply": 1, "alfi.smooth": 2, "alfi.pc_apply": 1}
    assert rows["alfi.pc_apply"]["launches_incl"] == 4
    assert {k: r["syncs"] for k, r in rows.items() if r["syncs"]} == {
        "alfi.pc_apply": 1, "alfi.re_step": 1, program_spans.UNSPANNED: 1}
    # idle gaps, by the innermost range at each gap's middle
    idle = {k: round(r["idle_s"] * 1e9) for k, r in rows.items()
            if r["idle_s"]}
    assert idle == {"alfi.re_step": 150, "alfi.smooth": 100,
                    "alfi.pc_apply": 50 + 180, "alfi.linear_step": 220,
                    program_spans.UNSPANNED: 90}
    assert round(red["idle_s"] * 1e9) == 790
    assert ns("alfi.re_step", "idle_s_incl") == 700
    assert red["window_s"] == pytest.approx(1e-6)
    assert len(program_spans.table(red)) == len(rows) + 2


def test_sync_sites_by_span_and_host_op():
    sites = program_spans.sync_sites(BASE + SPANS)
    assert sorted(map(tuple, sites)) == [
        ("alfi.pc_apply", "aten::_local_scalar_dense", 1),
        ("alfi.re_step", "(no host op)", 1),
        (program_spans.UNSPANNED, "(no host op)", 1)]
    assert program_spans.sync_sites(BASE[1:]) is None


def test_reduce_without_spans_or_window():
    red = program_spans.reduce(BASE)
    assert list(red["rows"]) == [program_spans.UNSPANNED]
    u = red["rows"][program_spans.UNSPANNED]
    assert round(u["device_s"] * 1e9) == 200 and u["launches"] == 4
    assert program_spans.reduce(BASE[1:]) is None
    record = {"spans": red, "sweeps": []}
    assert program_spans.span_row(record, "alfi.pc_apply") is None
    assert program_spans.span_row({"sweeps": []}, "alfi.smooth") is None


def test_summarize_unchanged_by_program_spans():
    a = trace.summarize(BASE)
    b = trace.summarize(BASE + SPANS)
    for key in ("busy_s", "ranges", "device_ops", "window_s",
                "device_events", "linked_events"):
        assert a[key] == b[key], key
    assert a["ranges"]["k1"]["device_s"] == pytest.approx(100e-9)


@pytest.fixture(scope="module")
def profiled():
    from conftest import small_config
    from benchmark.harness import registry

    torch.set_num_threads(1)
    mix = dict(registry.traffic("ladder_re500"))
    mix["rungs"] = [1, 10, 100]
    profile_spans.T_START = time.perf_counter()
    return profile_spans.run(CELL, 2 ** 40 + 3, device="cpu", count=True,
                             config=small_config(), mix=mix)


def test_profile_reports_the_span_metrics(profiled):
    m = profiled["metrics"]
    for name in profile_spans.SPAN_METRICS:
        assert name in m, name
    # the counter reads on the CPU too: about three reads a Krylov it
    assert 2.0 < m["host_syncs_per_krylov_it"] < 6.0
    # no device on the CPU: no launches, no device time
    assert m["cycle_launches_per_krylov_it"] == 0
    assert m["smoother_gs_ms_per_krylov_it"] == 0
    assert m["patch_inverse_ms_per_newton"] == 0
    for name in ("re_step_p95_s", "newton_steps_per_sweep",
                 "krylov_its_per_sweep", "ms_per_krylov_it"):
        assert m[name] > 0, name


def test_profile_counts_match_the_traced_steps(profiled):
    rows = profiled["spans"]["rows"]
    its, newton = profiled["traced"]
    assert rows["alfi.pc_apply"]["calls"] == its > 0
    assert rows["alfi.mg_setup"]["calls"] == newton > 0
    assert rows["alfi.re_step"]["calls"] == 3  # the whole short ladder
    assert [s["host_reads"] > 0 for s in profiled["sweeps"]] == [True] * 2


def test_profile_counts_entries_and_their_cost(profiled):
    n = profiled["entries"]
    assert n["alfi.re_step"] == 3
    assert n["alfi.fmg"] == 2 * n["alfi.pc_apply"] > 0
    assert n["alfi.host_read"] > 0
    cost = profiled["cost"]
    assert 0 < cost["span_ns"] < 10_000 and cost["spanned_ns"] < 10_000
