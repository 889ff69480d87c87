"""The port's driver and iters harness against the JAX package's, on
ldc2d baseN=4 nref=1 with the headline protocol's choices (pkp0 almg,
uniform, SUPG shakib, --restriction), f64 on the CPU:

* the parser has the JAX parser's option strings, choices and defaults;
* run_solver with --checkpoint resumes from its own checkpoints without
  solving and reproduces the counts;
* checkpoints cross both ways: the port's run_solver loads the JAX
  package's, and the JAX package's loads the port's, solving nothing;
* --paraview writes one VTU file per Re;
* --ndevices N > 1 outside an N-rank group raises, naming torchrun; a
  2-rank run of the iters harness prints the single-device counts;
* every choice the port does not have yet (item 12b's --rebalance)
  raises NotImplementedError, and every choice it has builds
  a solver (SV, bary, macrostar, Burman, the direct and AMG modes,
  --nref-vis, --mkl accepted and unused);
* the recovery code, with a stubbed ``newton`` or ``solve`` (twins of
  tests/test_continuation_recovery.py, the three recovery tests of
  tests/test_resume_distill.py and tests/test_newton_dtol.py): a diverged
  solve restores the last converged state and is not checkpointed, a
  diverged checkpoint is retried, a table-only checkpoint resumes and a
  cache miss below the frontier warm-starts from the nearest full one, a
  truncated npz is solved again, and Newton stops on dtol;
* ``python -m alfi_torch.examples.iters --device cpu`` prints both tables;
* performance_info lists the solve loop's events (no wall-clock gate);
* the committed log of the port's Re=10,000 sweep on the card has the
  JAX package's counts at every Re, and so have its step ladders (bfs2d
  coarse12 to Re 1000, bfs3d coarse55 to Re 500) where a JAX log has
  counts.
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


@pytest.mark.parametrize("port_log,ref_log,n", [
    ("sv_ldc2d_k2_nref1_re10000.log", "sv_ldc2d_k2_nref1_re10000_cpu.log",
     102),
    ("sv_ldc2d_k2_nref2_re10000.log", "sv_ldc2d_k2_nref2_re10000_cpu.log",
     102),
    ("sv_ldc3d_k3_nref1_re500.log", "sv_ldc3d_k3_nref1_re500.log", 7),
    ("merged_sv_ldc2d_k2_nref1_re10000.log",
     "sv_ldc2d_k2_nref1_re10000_cpu.log", 102),
    ("merged_sv_ldc3d_k3_nref1_re500.log", "sv_ldc3d_k3_nref1_re500.log",
     7),
])
def test_h100_sv_logs_have_the_jax_counts(port_log, ref_log, n):
    """The port's Scott-Vogelius sweeps on the card (iters2dsv at nref 1
    and 2 to Re 10,000, SV k=3 in 3D to Re 500; committed logs; the
    ``merged_`` ones run the merged level operator) against the JAX
    package's logs: equal counts at every Re.  Most dict lines of
    the JAX nref=2 log are table-only checkpoint rows (0/0); their counts
    are the ones its solves printed earlier in the same log."""
    from alfi_torch.examples.compare_iters import solve_records

    port = solve_records(os.path.join(REPO, "results", "torch_h100",
                                      port_log))
    ref = solve_records(os.path.join(REPO, "results", "logs", ref_log))
    assert len(port) == len(ref) == n
    assert port == ref
    assert (0, 0) not in ref.values()


@pytest.mark.parametrize("port_log,ref_log,n", [
    ("iters_bfs2d_coarse12_nref1_re1000.log",
     "torch_h100/iters_bfs2d_coarse12_nref1_re1000_jax_cpu.log", 16),
    ("iters_bfs3d_p1fb_coarse55_re500.log",
     "logs/bfs3d_p1fb_coarse55_re500.log", 8),
])
def test_h100_step_logs_have_the_jax_counts(port_log, ref_log, n):
    """The port's backwards-facing-step ladders on the card (committed
    logs: bfs2d on tests/fixtures/bfs2d_coarse12.msh to Re 1000, bfs3d
    [P1+FB]^3 on coarse55 to Re 500) against the JAX package's logs:
    equal counts at every Re both hold (the bfs3d log stops after Re 300;
    the card's Re 350-500 have no JAX record)."""
    from alfi_torch.examples.compare_iters import solve_records

    port = solve_records(os.path.join(REPO, "results", "torch_h100",
                                      port_log))
    ref = solve_records(os.path.join(REPO, "results", ref_log))
    common = sorted(set(port) & set(ref))
    assert len(common) == n
    assert [port[re] for re in common] == [ref[re] for re in common]


def test_performance_info_lists_the_solve_events(sweeps, capsys):
    _, _, tsolver, _, _ = sweeps
    tdriver.performance_info(tsolver)
    out = capsys.readouterr().out
    for name in ("SNESSolve", "KSPSolve", "SNESFunctionEval"):
        assert EVENTS[name]["count"] > 0 and EVENTS[name]["time"] > 0
        assert name + ":" in out


@pytest.mark.parametrize("extra", [
    ["--rebalance"],
], ids=lambda e: " ".join(e))
def test_unported_choices_raise(extra):
    args = _args(tdriver, extra)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        tdriver.get_solver(args, TorchLDC(4), device="cpu")


def test_ndevices_outside_a_group_raises(monkeypatch):
    """--ndevices 2 outside a 2-rank group: refused, naming torchrun (the
    twin of make_device_mesh's truncation refusal)."""
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    args = _args(tdriver, ["--ndevices", "2"])
    with pytest.raises(RuntimeError, match="torchrun"):
        tdriver.get_solver(args, TorchLDC(4), device="cpu")


ITERS_ARGV = ["--problem", "ldc2d", "--discretisation", "pkp0", "--mh",
              "uniform", "--baseN", "4", "--nref-start", "1", "--nref-end",
              "1", "--re-max", "10", "--device", "cpu"]


def _records(text):
    """(Re, linear_iter, nonlinear_iter) of each record run_solver
    printed."""
    import re

    return [tuple(int(x) for x in m) for m in re.findall(
        r"'Re': (\d+).*?'linear_iter': (\d+), 'nonlinear_iter': (\d+)",
        text)]


def test_two_rank_driver_run_prints_the_single_device_counts():
    """The iters harness with --ndevices 2 on two spawned gloo ranks
    (baseN=4, nref=1, Re 1 -> 10): rank 0 prints the single-device run's
    counts and tables, rank 1 prints nothing."""
    import contextlib
    import io

    from alfi_torch.examples import iters
    from alfi_torch.parallel.dryrun import driver_rank, spawn_ranks

    out = spawn_ranks(driver_rank, 2, args=(ITERS_ARGV + ["--ndevices", "2"],),
                      device="cpu", timeout=300)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        iters.main(ITERS_ARGV)
    single = buf.getvalue()
    assert _records(single) == _records(out[0]) != []
    assert [r for r in _records(single) if r[0] == 10] != []
    tables = [line for line in single.splitlines() if "&" in line]
    assert tables[:2] == [line for line in out[0].splitlines()
                          if "&" in line][:2]
    assert out[1] == ""


@pytest.mark.parametrize("extra", [
    ["--discretisation", "sv"],
    ["--mh", "bary"],
    ["--mh", "uniformbary"],
    ["--patch", "macro", "--mh", "bary"],
    ["--stabilisation-type", "burman"],
    ["--mkl"],
    ["--solver-type", "lu"],
    ["--solver-type", "allu"],
    ["--patch-composition", "multiplicative"],
    ["--solver-type", "alamg"],
    ["--solver-type", "simple"],
    ["--solver-type", "lsc"],
    ["--nref-vis", "1"],
], ids=lambda e: " ".join(e))
def test_ported_choices_build(extra):
    """Each choice builds its solver on the CPU at baseN=2, with the JAX
    package's discretisation, hierarchy, patches, composition, pressure
    null space (pinned by lu), stabilisation, gamma (0 for simple and
    lsc), AMG coarse size and visualisation refinement; the direct and
    AMG modes build no geometric multigrid."""
    args = _args(tdriver, extra)
    args.baseN = 2
    solver = tdriver.get_solver(args, TorchLDC(2), device="cpu")
    jsolver = jdriver.get_solver(_args(jdriver, extra), JaxLDC(2))
    assert type(solver).__name__ == type(jsolver).__name__
    assert solver.Z.dim == jsolver.Z.dim
    assert solver.mh.kind == jsolver.mh.kind == args.mh
    assert solver.nsp == jsolver.nsp
    np.testing.assert_array_equal(solver.bcset.mask[1].numpy(),
                                  np.asarray(jsolver.bcset.mask[1]))
    assert solver.gamma == jsolver.gamma
    assert solver.nref_vis == jsolver.nref_vis == args.nref_vis
    assert hasattr(solver, "vmg") == hasattr(jsolver, "vmg") == (
        args.solver_type == "almg")
    assert hasattr(solver, "vamg") == hasattr(jsolver, "vamg")
    if hasattr(solver, "vamg"):
        assert solver.vamg.n1 == jsolver.vamg.n1
    if args.solver_type != "almg":
        return
    assert ([ps.m for ps in solver.vmg.patchsets]
            == [ps.m for ps in jsolver.vmg.patchsets])
    assert solver.vmg.patch_composition == args.patch_composition
    assert (solver.vmg.stab_facet is None) == (
        args.stabilisation_type != "burman")


def _cross_problems(case):
    """(argv, port problem, JAX problem) of a checkpoint-crossing case."""
    from alfi_torch import problems as tproblems
    from alfi_tpu import problems as jproblems

    base = ["--discretisation", "pkp0", "--mh", "uniform", "--nref", "1",
            "--solver-type", "lu", "--checkpoint"]
    if case == "lu":
        return base + ["--baseN", "2"], TorchLDC(2), JaxLDC(2)
    if case == "dfg":
        return (base, tproblems.DfgBenchmarkProblem(n=8),
                jproblems.DfgBenchmarkProblem(n=8))
    return (base, tproblems.TwoDimLidDrivenCavityMMSProblem(2),
            jproblems.TwoDimLidDrivenCavityMMSProblem(2))


@pytest.mark.parametrize("case", ["lu", "dfg", "mms"])
def test_checkpoints_cross_both_ways(case, tmp_path):
    """The states of an lu solve (pressure pinned), a dfg solve (no
    pressure null space) and an MMS solve (forcing) checkpointed by one
    package load in the other, which solves nothing and holds the same
    state and counts."""
    argv, tproblem, jproblem = _cross_problems(case)
    res = [1]

    def run(mod, problem, path, forbid, **kw):
        args = mod.get_default_parser().parse_args(argv)
        solver = mod.get_solver(args, problem, **kw)
        solver.verbose = False
        if forbid:
            def no_solve(re):
                raise AssertionError("solved Re=%s instead of loading it"
                                     % re)
            solver.solve = no_solve
        out = _in_dir(path, lambda: mod.run_solver(solver, res, args))
        return solver, out

    for first, second in ((0, 1), (1, 0)):
        path = tmp_path / str(first)
        path.mkdir()
        runs = [(tdriver, tproblem, dict(device="cpu")),
                (jdriver, jproblem, {})]
        mod, problem, kw = runs[first]
        s1, r1 = run(mod, problem, path, False, **kw)
        mod, problem, kw = runs[second]
        s2, r2 = run(mod, problem, path, True, **kw)
        assert r2[1]["checkpointed"]
        assert _counts_of(r1) == _counts_of(r2)
        for a, b in zip(s1.z, s2.z):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _counts_of(results):
    return [tuple(int(r[k]) for k in COUNTS) for r in results.values()]


def test_macro_patches_need_bary():
    args = _args(tdriver, ["--patch", "macro"])
    with pytest.raises(ValueError, match="bary"):
        tdriver.get_solver(args, TorchLDC(4), device="cpu")


#: the ROADMAP.md items whose kwargs are ported: they build
PORTED_ITEMS = ("10h",)


@pytest.mark.parametrize("kw,item", [
    ({"nref_vis": 1}, "10h"),
    ({"rebalance_vertices": True}, "12b"),
], ids=lambda e: str(e))
def test_solver_kwargs_raise_off_their_defaults(kw, item):
    """A kwarg of a ROADMAP item still to port raises naming it; one of a
    ported item builds the JAX package's solver (visprolong: the refined
    mesh and the prolonged field at 1e-12)."""
    from alfi_torch import ConstantPressureSolver
    from alfi_tpu import ConstantPressureSolver as JaxSolver

    args = dict(nref=1, k=2, hierarchy="uniform", verbose=False)
    if item not in PORTED_ITEMS:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue 1 item %s$" % item):
            ConstantPressureSolver(TorchLDC(2), device="cpu", **args, **kw)
        return
    s = ConstantPressureSolver(TorchLDC(2), device="cpu", **args, **kw)
    j = JaxSolver(JaxLDC(2), **args, **kw)
    u = np.random.default_rng(0).standard_normal((s.Z.V.ndof, 2))
    (ut, mt, _), (uj, mj, _) = (s.visprolong(torch.as_tensor(u)),
                                j.visprolong(u))
    np.testing.assert_array_equal(mt.cells, mj.cells)
    assert np.abs(ut.numpy() - np.asarray(uj)).max() <= 1e-12 * np.abs(
        np.asarray(uj)).max()


def test_solver_kwargs_take_the_reference_defaults():
    """The reference's defaults of patch, use_mkl, nref_vis,
    patch_composition and rebalance_vertices build; use_mkl is unused."""
    from alfi_torch import ConstantPressureSolver

    kw = dict(nref=1, k=2, hierarchy="uniform", verbose=False,
              device="cpu")
    a = ConstantPressureSolver(TorchLDC(2), patch="star", use_mkl=False,
                               nref_vis=0, patch_composition="additive",
                               rebalance_vertices=False, **kw)
    b = ConstantPressureSolver(TorchLDC(2), use_mkl=True, **kw)
    assert a.patch == b.patch == "star"
    assert a.Z.dim == b.Z.dim


# ----------------------------------------------------------------------
# recovery (stubbed newton / solve)
# ----------------------------------------------------------------------
def _tiny_solver():
    from alfi_torch import ConstantPressureSolver

    return ConstantPressureSolver(
        TorchLDC(4), nref=1, k=2, solver_type="almg", hierarchy="uniform",
        gamma=1e4, verbose=False, device="cpu")


def _chk_args():
    args, _ = tdriver.get_default_parser().parse_known_args(
        ["--discretisation", "pkp0", "--checkpoint"])
    return args


def test_diverged_solve_restores_last_state(monkeypatch):
    import alfi_torch.solver as solver_mod

    s = _tiny_solver()
    s.solve(1)
    z_good = s.z
    real_newton = solver_mod.newton

    def diverging_newton(residual, linear_solve, z0, **kw):
        z, info = real_newton(residual, linear_solve, z0,
                              **dict(kw, maxit=1, atol=0.0, rtol=0.0))
        info.converged = False
        info.reason = "forced divergence (test)"
        return (torch.full_like(z[0], float("nan")), z[1]), info

    monkeypatch.setattr(solver_mod, "newton", diverging_newton)
    _, info = s.solve(10)
    assert not info["converged"]
    assert s.z is z_good  # the poisoned iterate must not stick
    monkeypatch.setattr(solver_mod, "newton", real_newton)
    _, info2 = s.solve(10)  # the continuation recovers from z_good
    assert info2["converged"]


def test_diverged_solve_not_checkpointed(monkeypatch, tmp_path):
    import alfi_torch.solver as solver_mod

    monkeypatch.chdir(tmp_path)
    s = _tiny_solver()
    real_newton = solver_mod.newton
    calls = {"n": 0}

    def newton_fail_at_10(residual, linear_solve, z0, **kw):
        z, info = real_newton(residual, linear_solve, z0, **kw)
        calls["n"] += 1
        if calls["n"] == 2:  # the Re=10 step
            info.converged = False
        return z, info

    monkeypatch.setattr(solver_mod, "newton", newton_fail_at_10)
    results = tdriver.run_solver(s, [1, 10], _chk_args())
    chkptdir = tmp_path / ("checkpoint/%i" % s.Z.dim)
    assert (chkptdir / "nssolution-Re-1.npz").exists()
    assert not (chkptdir / "nssolution-Re-10.npz").exists()
    assert results[1]["converged"] and not results[10]["converged"]


def test_diverged_checkpoint_retried(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    s = _tiny_solver()
    chkptdir = tmp_path / ("checkpoint/%i" % s.Z.dim)
    chkptdir.mkdir(parents=True)
    np.savez(chkptdir / "nssolution-Re-1.npz",
             u=np.full(tuple(s.z[0].shape), np.nan),
             p=np.zeros(tuple(s.z[1].shape)), nu=2.0, linear_iter=0,
             nonlinear_iter=1, time=0.0, converged=False)
    results = tdriver.run_solver(s, [1], _chk_args())
    assert results[1]["converged"]  # solved again, not loaded
    assert not results[1].get("checkpointed", False)
    with np.load(chkptdir / "nssolution-Re-1.npz") as chk:
        assert bool(chk["converged"])  # overwritten by the good solve


def test_table_only_checkpoint_resume(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    s = _tiny_solver()
    results = tdriver.run_solver(s, [1, 10], _chk_args())
    chkptdir = tmp_path / ("checkpoint/%i" % s.Z.dim)
    # Re=1 becomes table-only, Re=10 keeps its state
    with np.load(chkptdir / "nssolution-Re-1.npz") as chk:
        info = {k: chk[k] for k in chk.files
                if k not in ("u", "p", "numbering")}
    np.savez(chkptdir / "nssolution-Re-1.npz", **info)

    s2 = _tiny_solver()
    z0 = s2.z
    results2 = tdriver.run_solver(s2, [1, 10, 20], _chk_args())
    # Re=1: the table row, no state loaded, nothing solved
    assert results2[1]["checkpointed"]
    assert results2[1]["linear_iter"] == results[1]["linear_iter"]
    # Re=10: the full frontier state loaded
    assert results2[10]["checkpointed"]
    assert not torch.allclose(s2.z[0], z0[0])
    # Re=20: solved, warm-started from the frontier state
    assert results2[20]["converged"]
    assert not results2[20].get("checkpointed", False)


class _FakeSolver:
    """run_solver's contract and nothing else: records the state each
    solve starts from, so the warm start is observable."""

    def __init__(self, dim=777):
        import types

        self.Z = types.SimpleNamespace(dim=dim)
        self.device = torch.device("cpu")
        self.z = (torch.zeros(8, dtype=torch.float64),
                  torch.zeros(3, dtype=torch.float64))
        self.start_states = {}

    def solve(self, re):
        self.start_states[re] = self.z[0].clone()
        self.z = (torch.full((8,), float(re), dtype=torch.float64),
                  torch.zeros(3, dtype=torch.float64))
        return self.z, {"Re": re, "nu": 1.0 / re, "linear_iter": 4,
                        "nonlinear_iter": 2, "time": 0.1,
                        "converged": True}


def test_warm_start_below_frontier(monkeypatch, tmp_path):
    """A cache miss below the frontier warm-starts from the nearest lower
    full checkpoint (table-only rows never touch solver.z)."""
    from alfi_torch.interop import numbering_tag

    monkeypatch.chdir(tmp_path)
    s = _FakeSolver()
    ck = tmp_path / ("checkpoint/%d" % s.Z.dim)
    ck.mkdir(parents=True)
    # Re=1 full and converged, Re=10 table-only, Re=5 missing
    np.savez(ck / "nssolution-Re-1.npz", u=np.full(8, 1.0), p=np.zeros(3),
             numbering=numbering_tag(), nu=1.0, linear_iter=3,
             nonlinear_iter=1, time=0.1, converged=True)
    np.savez(ck / "nssolution-Re-10.npz", nu=0.1, linear_iter=5,
             nonlinear_iter=2, time=0.1, converged=True)
    results = tdriver.run_solver(s, [1, 5, 10], _chk_args())
    assert results[1]["checkpointed"] and results[10]["checkpointed"]
    # the Re=5 solve started from the Re=1 state, not from zero
    assert torch.all(s.start_states[5] == 1.0)


def test_truncated_checkpoint_resolves(monkeypatch, tmp_path):
    """A truncated npz (an interrupted copy) is solved again."""
    monkeypatch.chdir(tmp_path)
    s = _FakeSolver()
    ck = tmp_path / ("checkpoint/%d" % s.Z.dim)
    ck.mkdir(parents=True)
    (ck / "nssolution-Re-1.npz").write_bytes(b"PK\x03\x04garbage")
    results = tdriver.run_solver(s, [1], _chk_args())
    assert results[1]["converged"]
    assert 1 in s.start_states  # it really solved


def _diverging_system():
    """A system whose Newton steps multiply the residual by 100."""

    def residual(z):
        return z

    def linear_solve(z, F):
        return 99.0 * z, 1

    return residual, linear_solve


def test_newton_dtol_aborts_early():
    from alfi_torch.solvers.newton import newton

    residual, linear_solve = _diverging_system()
    _, info = newton(residual, linear_solve,
                     torch.tensor(1.0, dtype=torch.float64), maxit=20,
                     dtol=1e4)
    assert not info.converged
    assert info.reason == "diverged_dtol"
    # ||F|| = 100^k crosses 1e4 ||F0|| at k = 3
    assert info.nonlinear_iter <= 3


def test_newton_dtol_off_reaches_maxit():
    from alfi_torch.solvers.newton import newton

    residual, linear_solve = _diverging_system()
    _, info = newton(residual, linear_solve,
                     torch.tensor(1.0, dtype=torch.float64), maxit=12,
                     dtol=float("inf"))
    assert not info.converged
    assert info.reason == "max_it"
    assert info.nonlinear_iter == 12


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


def test_iters_harness_runs_the_sv_protocol(tmp_path, monkeypatch, capsys):
    """The iters2dsv protocol (SV k=2, bary, macrostar, Burman 5e-3,
    --restriction) at baseN=3 nref=1: the JAX package's harness takes
    10/2 at Re 1 and 9/2 at Re 10 (kpn 4.50) there, and so does the
    port's."""
    from alfi_torch.examples.compare_iters import solve_records
    from alfi_torch.examples.iters import main

    torch.set_num_threads(1)
    monkeypatch.chdir(tmp_path)
    main(["--problem", "ldc2d", "--discretisation", "sv", "--mh", "bary",
          "--patch", "macro", "--stabilisation-type", "burman",
          "--stabilisation-weight", "5e-3", "--restriction", "--baseN",
          "3", "--k", "2", "--nref-start", "1", "--nref-end", "1",
          "--re-max", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    log = tmp_path / "run.log"
    log.write_text(out)
    assert solve_records(str(log)) == {1.0: (10, 2), 10.0: (9, 2)}
    assert "1\t& $1.56\\times 10^3$\t& 4.50\\\\" in out


def test_h100_merged_3d_log_keeps_the_blocked_counts():
    """ldc3d [P2+FB]^3 nref=1 to Re 5000 on the card, the merged level
    operator (committed log) against the blocked route's run of the same
    sweep: the new summation order moved no count at any of the 52 Re."""
    from alfi_torch.examples.compare_iters import solve_records

    merged, blocked = (solve_records(os.path.join(
        REPO, "results", "torch_h100", name)) for name in (
        "merged_iters_ldc3d_p2fb_nref1_re5000.log",
        "iters_ldc3d_p2fb_nref1_re5000.log"))
    assert len(merged) == len(blocked) == 52
    assert merged == blocked


def test_solve_records_of_a_log_without_its_table(tmp_path):
    """A harness log that never reached its table (no dict lines, as the
    JAX package's 3D logs that were cut and resumed) gives the counts its
    solves printed, the last solve of an Re counting."""
    from alfi_torch.examples.compare_iters import solve_records

    log = tmp_path / "cut.log"
    log.write_text(
        "Solving for Re = 1\nNonlinear solve converged in 2 iterations\n"
        "Time taken: 0.1 min in 5 iterations (2.50 Krylov iters per "
        "Newton step)\nSolving for Re = 10\nNonlinear solve converged "
        "in 3 iterations\nTime taken: 0.1 min in 7 iterations\n"
        "Solving for Re = 10\nNonlinear solve converged in 2 iterations\n"
        "Time taken: 0.1 min in 4 iterations\n")
    assert solve_records(str(log)) == {1.0: (5, 2), 10.0: (4, 2)}


def test_iters_harness_runs_dfg(tmp_path, monkeypatch, capsys):
    """--problem dfg at --n 8 (the DFG channel, no pressure null space):
    Re 1 and 10 converge, and the checkpoints are keyed by the dof
    count."""
    from alfi_torch.examples.compare_iters import solve_records
    from alfi_torch.examples.iters import main

    monkeypatch.chdir(tmp_path)
    main(["--problem", "dfg", "--discretisation", "pkp0", "--mh",
          "uniform", "--stabilisation-type", "supg", "--restriction",
          "--n", "8", "--nref-start", "1", "--nref-end", "1", "--re-max",
          "10", "--checkpoint", "--device", "cpu"])
    out = capsys.readouterr().out
    log = tmp_path / "run.log"
    log.write_text(out)
    records = solve_records(str(log))
    assert sorted(records) == [1.0, 10.0]
    assert "DIVERGED" not in out
    (ndofs,) = os.listdir(tmp_path / "checkpoint")
    assert "Number of degrees of freedom: %s" % ndofs in out


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
