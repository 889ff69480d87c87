"""The port's driver and iters harness against the JAX package's, on
ldc2d baseN=4 nref=1 with the headline protocol's choices (pkp0 almg,
uniform, SUPG shakib, --restriction), f64 on the CPU:

* the parser has the JAX parser's option strings, choices and defaults;
* run_solver with --checkpoint resumes from its own checkpoints without
  solving and reproduces the counts;
* checkpoints cross both ways: the port's run_solver loads the JAX
  package's, and the JAX package's loads the port's, solving nothing;
* --paraview writes one VTU file per Re;
* every choice the port does not have yet raises NotImplementedError;
* ``python -m alfi_torch.examples.iters --device cpu`` prints both tables;
* performance_info lists the solve loop's events (no wall-clock gate);
* the committed log of the port's Re=10,000 sweep on the card has the
  JAX package's counts at every Re.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from alfi_torch import driver as tdriver
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_torch.utils.events import EVENTS
from alfi_tpu import driver as jdriver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--discretisation", "pkp0", "--mh", "uniform", "--baseN", "4",
        "--nref", "1", "--stabilisation-type", "supg", "--restriction",
        "--checkpoint", "--paraview"]
RES = [1, 10]
COUNTS = ("linear_iter", "nonlinear_iter")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _args(parser_mod, extra=()):
    return parser_mod.get_default_parser().parse_args(ARGV + list(extra))


def _in_dir(path, fn):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _port_run(path, forbid_solve=False):
    args = _args(tdriver)
    solver = tdriver.get_solver(args, TorchLDC(4), device="cpu")
    solver.verbose = False
    if forbid_solve:
        def no_solve(re):
            raise AssertionError("solved Re=%s instead of loading it" % re)
        solver.solve = no_solve
    return solver, _in_dir(path, lambda: tdriver.run_solver(solver, RES,
                                                            args))


def _jax_run(path, forbid_solve=False):
    args = _args(jdriver)
    solver = jdriver.get_solver(args, JaxLDC(4))
    solver.verbose = False
    if forbid_solve:
        def no_solve(re):
            raise AssertionError("solved Re=%s instead of loading it" % re)
        solver.solve = no_solve
    return solver, _in_dir(path, lambda: jdriver.run_solver(solver, RES,
                                                            args))


def _counts(results):
    return [tuple(int(results[re][k]) for k in COUNTS) for re in RES]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """One port sweep and one JAX sweep, each writing its checkpoints
    into a directory of its own."""
    torch.set_num_threads(1)
    tdir = tmp_path_factory.mktemp("port")
    jdir = tmp_path_factory.mktemp("jax")
    tsolver, tres = _port_run(tdir)
    _, jres = _jax_run(jdir)
    return tdir, tres, tsolver, jdir, jres


def test_parser_matches_jax():
    def table(p):
        return sorted((a.option_strings, a.dest, a.default, a.choices,
                       a.required, a.type) for a in p._actions)

    assert table(tdriver.get_default_parser()) == \
        table(jdriver.get_default_parser())


def test_sweep_converges_with_the_jax_counts(sweeps):
    _, tres, _, _, jres = sweeps
    assert all(tres[re]["converged"] for re in RES)
    assert _counts(tres) == _counts(jres) == [(7, 2), (7, 2)]


def test_port_resumes_from_its_own_checkpoints(sweeps):
    tdir, tres, tsolver, _, _ = sweeps
    solver, res2 = _port_run(tdir, forbid_solve=True)
    assert all(res2[re]["checkpointed"] for re in RES)
    assert _counts(res2) == _counts(tres)
    # the state carried is the last solve's
    for a, b in zip(solver.z, tsolver.z):
        assert torch.equal(a, b)


def test_port_loads_jax_checkpoints(sweeps):
    _, _, _, jdir, jres = sweeps
    solver, res2 = _port_run(jdir, forbid_solve=True)
    assert all(res2[re]["checkpointed"] for re in RES)
    assert _counts(res2) == _counts(jres)
    path = os.path.join(jdir, "checkpoint", str(solver.Z.dim),
                        "nssolution-Re-10.npz")
    with np.load(path) as chk:
        assert np.array_equal(solver.z[0].numpy(), chk["u"])
        assert np.array_equal(solver.z[1].numpy(), chk["p"])


def test_jax_loads_port_checkpoints(sweeps):
    tdir, tres, tsolver, _, _ = sweeps
    solver, res2 = _jax_run(tdir, forbid_solve=True)
    assert all(res2[re]["checkpointed"] for re in RES)
    assert _counts(res2) == _counts(tres)
    for a, b in zip(solver.z, tsolver.z):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_paraview_writes_one_file_per_re(sweeps):
    tdir, _, tsolver, _, _ = sweeps
    mesh = tsolver.mesh
    for re in RES:
        path = os.path.join(tdir, "output", str(tsolver.Z.dim),
                            "velocity-Re-%s.vtu" % re)
        with open(path) as f:
            text = f.read()
        assert ('NumberOfPoints="%d" NumberOfCells="%d"'
                % (mesh.num_vertices, mesh.num_cells)) in text
        assert text.rstrip().endswith("</VTKFile>")


def test_h100_log_has_the_jax_counts():
    """The port's Re=10,000 sweep on the card (committed log) against the
    JAX package's committed log of the same protocol: equal counts at
    every Re."""
    from alfi_torch.examples.compare_iters import solve_records

    port = solve_records(os.path.join(
        REPO, "results", "torch_h100", "iters_ldc2d_nref2_re10000.log"))
    ref = solve_records(os.path.join(
        REPO, "results", "iters_ldc2d_nref2_re10000.log"))
    assert len(port) == len(ref) == 102
    assert port == ref


def test_performance_info_lists_the_solve_events(sweeps, capsys):
    _, _, tsolver, _, _ = sweeps
    tdriver.performance_info(tsolver)
    out = capsys.readouterr().out
    for name in ("SNESSolve", "KSPSolve", "SNESFunctionEval"):
        assert EVENTS[name]["count"] > 0 and EVENTS[name]["time"] > 0
        assert name + ":" in out


@pytest.mark.parametrize("extra", [
    ["--discretisation", "sv"],
    ["--solver-type", "lu"],
    ["--solver-type", "allu"],
    ["--solver-type", "alamg"],
    ["--solver-type", "simple"],
    ["--solver-type", "lsc"],
    ["--mh", "bary"],
    ["--mh", "uniformbary"],
    ["--patch", "macro"],
    ["--patch-composition", "multiplicative"],
    ["--stabilisation-type", "burman"],
    ["--nref-vis", "1"],
    ["--mkl"],
    ["--ndevices", "2"],
    ["--rebalance"],
], ids=lambda e: " ".join(e))
def test_unported_choices_raise(extra):
    args = _args(tdriver, extra)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        tdriver.get_solver(args, TorchLDC(4), device="cpu")


def test_iters_harness_prints_both_tables(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "alfi_torch.examples.iters", "--device",
         "cpu", "--problem", "ldc2d", "--discretisation", "pkp0", "--mh",
         "uniform", "--baseN", "4", "--k", "2", "--nref-start", "1",
         "--nref-end", "1", "--re-max", "10", "--stabilisation-type",
         "supg"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [ln for ln in proc.stdout.splitlines()
            if ln.startswith(("nref", "1\t&"))]
    # header and one nref=1 row, per table: Krylov per Newton, seconds
    assert [r.split("\t&")[0].strip() for r in rows] == \
        ["nref", "1", "nref", "1"]
    kpn = float(rows[1].split("&")[-1].strip().rstrip("\\"))
    assert kpn == 3.5  # 7 Krylov / 2 Newton at Re=10, as the JAX package
    assert float(rows[3].split("&")[-1].strip().rstrip("\\")) > 0


def test_iters_harness_rejects_unported_problems():
    from alfi_torch.examples.iters import main

    with pytest.raises(NotImplementedError, match="item 10"):
        main(["--problem", "dfg", "--discretisation", "pkp0",
              "--nref-start", "1", "--nref-end", "1", "--device", "cpu"])


def test_iters_harness_runs_the_3d_cavity(tmp_path, monkeypatch, capsys):
    """--problem ldc3d at baseN=2 nref=1 ([P2+FB]^3-P0, 5,163 dofs): two
    solve records with the JAX package's counts 6/2 and 5/2, and the
    checkpoint directory keyed by the dof count."""
    from alfi_torch.examples.compare_iters import solve_records
    from alfi_torch.examples.iters import main, reynolds_ladder

    torch.set_num_threads(1)
    monkeypatch.chdir(tmp_path)
    main(["--problem", "ldc3d", "--discretisation", "pkp0", "--mh",
          "uniform", "--k", "2", "--baseN", "2", "--nref-start", "1",
          "--nref-end", "1", "--re-max", "10", "--checkpoint", "--device",
          "cpu"])
    out = capsys.readouterr().out
    assert "Number of degrees of freedom: 5163" in out
    log = tmp_path / "run.log"
    log.write_text(out)
    assert solve_records(str(log)) == {1.0: (6, 2), 10.0: (5, 2)}
    assert sorted(os.listdir(tmp_path / "checkpoint" / "5163")) == [
        "nssolution-Re-1.npz", "nssolution-Re-10.npz"]
    assert reynolds_ladder(400, bfs=True) == [1, 10, 50, 100, 150, 200, 250,
                                              300, 350, 400]
    assert reynolds_ladder(300) == [1, 10, 100, 200, 300]
