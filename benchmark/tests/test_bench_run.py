"""The harness end to end on the CPU at ldc2d baseN 4, nref 1, through the
plain kernels: the result line, and ``correct`` coming out false when the
timed path is broken underneath or its answers are rounded to float32."""

import json
import time

import pytest
import torch

from benchmark.harness import cell
from conftest import CELL

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def _run(bench, config, mix, trace=0, hook=None, seed=2 ** 40 + 3):
    torch.set_num_threads(1)
    return cell.run(bench, CELL, seed, 0.0, bool(trace),
                    t_start=time.perf_counter(), device="cpu",
                    config=config, mix=mix, system_hook=hook)


def test_run_small(bench, config, mix):
    r = _run(bench, config, mix)
    assert list(r) == KEYS  # "check" comes last
    json.loads(json.dumps(r))
    assert r["correct"] is True
    assert r["attempted"] == 3 and r["failed"] == 0
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert set(r["metrics"]) <= e2e
    # sweep_s is the 3D cell's alone, and the CPU has no device peak
    assert set(r["metrics"]) == {"setup_s"}
    assert r["check"]["residual_max"]["value"] < \
        r["check"]["residual_max"]["limit"]
    assert r["check"]["steps_unjudged"] == {"value": 0, "limit": 0}


def test_run_small_traced(bench, config, mix):
    r = _run(bench, config, mix, trace=1)
    assert list(r) == KEYS[:5] + ["breakdown", "check"]
    assert r["correct"] is True
    # two sweeps: the profiled one is the window's second
    assert r["attempted"] == 6
    m = r["metrics"]
    assert set(m) <= {x["name"] for x in bench["per_layer"]}
    for name in ("sweep_wall_s", "re_step_p95_s.2d",
                 "newton_steps_per_sweep.2d", "krylov_its_per_sweep.2d",
                 "ms_per_krylov_it.2d", "mg_setup_ms_per_newton.2d"):
        assert m[name]["value"] > 0, name
    # no device on the CPU: the device readers find nothing to read
    for name in ("k1_roofline.2d", "km_roofline.2d", "device_idle_pct.2d"):
        assert name not in m
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(system):
    """Each step returns the state it started from."""
    s = system.solver

    def solve(re, hooks=None):
        return s.z, {"Re": re, "linear_iter": 0, "nonlinear_iter": 0,
                     "converged": True}

    s.solve = solve


def _altered(system):
    """Each step's answer is altered where it is produced: one interior
    velocity dof moved by 1e-4."""
    s = system.solver
    solve = s.solve
    x = torch.as_tensor(s.Z.V.dof_coords)
    k = int(((x - 1.0) ** 2).sum(1).argmin())

    def altered(re, hooks=None):
        z, info = solve(re)
        u = z[0].clone()
        u[k, 0] += 1e-4
        s.z = (u, z[1])
        return s.z, info

    s.solve = altered


def _control_f32(system):
    """The control: each step's state in float32, the precision below the
    configuration's."""
    s = system.solver
    solve = s.solve

    def rounded(re, hooks=None):
        z, info = solve(re)
        return tuple(x.float().double() for x in z), info

    s.solve = rounded


@pytest.mark.parametrize("hook", [_unchanged, _altered, _control_f32],
                         ids=["state_unchanged", "answer_altered",
                              "control_float32"])
def test_broken_path_is_not_correct(bench, config, mix, hook):
    r = _run(bench, config, mix, hook=hook)
    assert r["correct"] is False
    assert r["failed"] > 0
    v = r["check"]["residual_max"]
    assert v["value"] > v["limit"]
