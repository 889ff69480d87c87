"""The harness end to end on the Scott-Vogelius configuration on the CPU:
``sv2d_k2`` (alfi's iters2dsv row) cut to ldc2d baseN 4, nref 1, through
the plain kernels.  The result line of an untraced and a traced run, read
by ``reference/ns_sv.py``, and ``correct`` coming out false when the timed
path is broken underneath."""

import copy
import time

import pytest
import torch

from benchmark.harness import cell, registry

CELL = "sv2d_k2.re500"


@pytest.fixture
def sv_config():
    cfg = copy.deepcopy(registry.config("sv2d_k2"))
    flags = cfg["flags"]
    flags[flags.index("--baseN") + 1] = "4"
    flags[flags.index("--nref") + 1] = "1"
    cfg["problem"]["args"]["baseN"] = 4
    cfg["reference"]["cells_per_side"] = 8
    return cfg


def _run(bench, config, mix, trace=0, hook=None, seed=2 ** 40 + 5):
    torch.set_num_threads(1)
    return cell.run(bench, CELL, seed, 0.0, bool(trace),
                    t_start=time.perf_counter(), device="cpu",
                    config=config, mix=mix, system_hook=hook)


def test_sv_run_small(bench, sv_config, mix):
    r = _run(bench, sv_config, mix)
    assert r["correct"] is True
    assert r["attempted"] == 3 and r["failed"] == 0
    # no sweep_s here, and the CPU has no device peak
    assert set(r["metrics"]) == {"setup_s"}
    assert r["check"]["steps_unjudged"] == {"value": 0, "limit": 0}
    assert r["check"]["residual_max"]["value"] < 1e-6


def test_sv_run_small_traced(bench, sv_config, mix):
    r = _run(bench, sv_config, mix, trace=1)
    assert r["correct"] is True and r["attempted"] == 6
    m = r["metrics"]
    for name in ("sweep_wall_s.sv2d", "re_step_p95_s.sv2d",
                 "newton_steps_per_sweep.sv2d", "krylov_its_per_sweep.sv2d",
                 "ms_per_krylov_it.sv2d", "mg_setup_ms_per_newton.sv2d"):
        assert m[name]["value"] > 0, name
    # no device on the CPU: the device readers find nothing to read
    for name in ("k1_roofline.sv2d", "km_roofline.sv2d",
                 "device_idle_pct.sv2d"):
        assert name not in m
    # nothing of the other cells
    assert all(n.endswith(".sv2d") for n in m)


def _unchanged(system):
    """Each step returns the state it started from."""
    s = system.solver

    def solve(re, hooks=None):
        return s.z, {"Re": re, "linear_iter": 0, "nonlinear_iter": 0,
                     "converged": True}

    s.solve = solve


def _control_f32(system):
    """Each step's state in float32, the precision below the
    configuration's."""
    s = system.solver
    solve = s.solve

    def rounded(re, hooks=None):
        z, info = solve(re)
        return tuple(x.float().double() for x in z), info

    s.solve = rounded


@pytest.mark.parametrize("hook", [_unchanged, _control_f32],
                         ids=["state_unchanged", "control_float32"])
def test_sv_broken_path_is_not_correct(bench, sv_config, mix, hook):
    r = _run(bench, sv_config, mix, hook=hook)
    assert r["correct"] is False
    v = r["check"]["residual_max"]
    assert v["value"] > v["limit"]
