"""The program's spans and its host-read counter
(``alfi_torch/utils/events.py``) on a small almg solve: ldc2d [P2]^2-P0,
baseN 4, nref 1, on the CPU through the plain kernels.

With no profiler recording, a span opens no ``record_function``; under
``torch.profiler`` the spans nest layer in layer as the solve does, in the
counts the cycle's shape gives, and the iterates are the same bits.  Every
device-to-host scalar read of the solve path is counted: the counts are
the exact ones of FGMRES's, Newton's and the Reynolds step's tests."""

import pytest
import torch

import alfi_torch.solver as solver_mod
from alfi_torch import ConstantPressureSolver, ScottVogeliusSolver
from alfi_torch.problems import TwoDimLidDrivenCavityProblem
from alfi_torch.solvers.krylov import fgmres
from alfi_torch.utils import events

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
RES = (1, 10)
#: the levels above the coarse one
L = KW["nref"]

#: each span and the spans it may sit directly inside (None: outermost)
PARENTS = {
    "alfi.re_step": {None},
    "alfi.residual": {"alfi.re_step"},
    "alfi.linear_step": {"alfi.re_step"},
    "alfi.transfer_setup": {"alfi.re_step"},
    "alfi.host_read": {"alfi.re_step", "alfi.linear_step"},
    "alfi.jacobian_matvec": {"alfi.linear_step"},
    "alfi.mg_setup": {"alfi.linear_step"},
    "alfi.mg_setup.tensors": {"alfi.mg_setup"},
    "alfi.mg_setup.patch_inverse": {"alfi.mg_setup"},
    "alfi.mg_setup.coarse_factor": {"alfi.mg_setup"},
    "alfi.mg_setup.level_assemble": {"alfi.mg_setup"},
    "alfi.pc_apply": {"alfi.linear_step"},
    "alfi.fmg": {"alfi.pc_apply"},
    "alfi.smooth": {"alfi.fmg"},
    "alfi.patch_apply": {"alfi.smooth"},
    # the smoothers' and the cycle's residuals, and the outer Jacobian
    # action, which almg takes from the finest level operator
    "alfi.level_apply": {"alfi.smooth", "alfi.fmg", "alfi.jacobian_matvec"},
    "alfi.prolong": {"alfi.fmg"},
    "alfi.restrict": {"alfi.fmg"},
    "alfi.coarse_solve": {"alfi.fmg"},
}

#: the spans that Burman's stabilisation adds (Scott-Vogelius), and the
#: spans each may sit directly inside
SV_PARENTS = {
    "alfi.mg_setup.facet_tensors": {"alfi.mg_setup"},
    "alfi.mg_setup.facet_contract": {"alfi.mg_setup.patch_inverse"},
    # the Newton residual, and the step's gamma-free check after the solve
    "alfi.burman_residual": {"alfi.residual", "alfi.re_step"},
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def fgmres_reads(its, restart, maxit):
    """The host reads of one converged ``fgmres`` solve of ``its``
    iterations: the target, each loop test that reaches the residual (a
    cycle's last test does not where the cycle ran full), the restart
    loop's tests (none with ``maxit <= restart``), ``converged``."""
    cycles = -(-its // restart)
    inner = its if its % restart == 0 else its + 1
    outer = 0 if maxit <= restart else cycles + 1
    return 1 + inner + outer + 1


def newton_reads(info):
    """The host reads of one Newton solve: ||F|| at the start and after
    each step, ||dz|| and ||z|| after each step that the residual tests
    did not end."""
    n = info.nonlinear_iter
    ended = 1 if info.reason in ("atol", "rtol") else 0
    return 1 + n + 2 * (n - ended) if n else 1


def _solver():
    return ConstantPressureSolver(TwoDimLidDrivenCavityProblem(4),
                                  device="cpu", **KW)


def _sv_solver():
    """alfi's iters2dsv row ([P2]^2-P1disc, barycentric, macrostar,
    Burman) at ldc2d baseN 2, nref 1."""
    return ScottVogeliusSolver(
        TwoDimLidDrivenCavityProblem(2), device="cpu",
        **dict(KW, hierarchy="bary", patch="macro",
               stabilisation_type="burman"))


def _spans(prof):
    """[(name, parent name)] of the profile's alfi.* ranges, by nesting."""
    rs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("alfi.")),
                key=lambda r: (r[0], -r[1]))
    out, stack = [], []
    for start, end, name in rs:
        while stack and stack[-1][1] < end:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((start, end, name))
    return out


def _sweep(monkeypatch, profile, make=_solver):
    """Re 1 and Re 10 from rest, with the opener counted and every
    fgmres and Newton call recorded; ``profile``: under torch.profiler;
    ``make``: the solver's factory."""
    torch.set_num_threads(1)
    opened, calls, newtons = [], [], []
    real_fgmres, real_newton = solver_mod.fgmres, solver_mod.newton

    def opener(name):
        opened.append(name)
        return torch.profiler.record_function(name)

    def counted_fgmres(*args, **kwargs):
        n0 = events.COUNTERS["host_reads"]
        x, info = real_fgmres(*args, **kwargs)
        calls.append((info["iters"], kwargs["restart"], kwargs["maxit"],
                      info["converged"],
                      events.COUNTERS["host_reads"] - n0))
        return x, info

    def recorded_newton(*args, **kwargs):
        z, info = real_newton(*args, **kwargs)
        newtons.append(info)
        return z, info

    monkeypatch.setattr(events, "_record_function", opener)
    monkeypatch.setattr(solver_mod, "fgmres", counted_fgmres)
    monkeypatch.setattr(solver_mod, "newton", recorded_newton)
    s = make()
    steps = []
    prof = None
    if profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
    try:
        for re in RES:
            n0, c0 = dict(events.COUNTERS), len(calls)
            z, info = s.solve(re)
            counts = {k: events.COUNTERS[k] - n0[k] for k in n0}
            steps.append({"z": [x.clone() for x in z], "info": info,
                          "reads": counts["host_reads"], "counts": counts,
                          "fgmres": calls[c0:], "newton": newtons[-1]})
    finally:
        if prof is not None:
            prof.stop()
    return {"solver": s, "steps": steps, "opened": opened,
            "spans": _spans(prof) if prof is not None else None}


@pytest.fixture(scope="module")
def plain():
    with pytest.MonkeyPatch.context() as mp:
        return _sweep(mp, profile=False)


@pytest.fixture(scope="module")
def profiled():
    with pytest.MonkeyPatch.context() as mp:
        return _sweep(mp, profile=True)


@pytest.fixture(scope="module")
def sv_profiled():
    with pytest.MonkeyPatch.context() as mp:
        return _sweep(mp, profile=True, make=_sv_solver)


def test_no_profiler_opens_no_range(plain):
    assert plain["opened"] == []
    assert [st["info"]["converged"] for st in plain["steps"]] == [True] * 2


def test_iterates_bit_identical_under_profiler(plain, profiled):
    for a, b in zip(plain["steps"], profiled["steps"]):
        assert a["info"]["linear_iter"] == b["info"]["linear_iter"]
        for x, y in zip(a["z"], b["z"]):
            assert torch.equal(x, y)


def test_spans_nest_as_the_layers(profiled):
    spans = profiled["spans"]
    assert {n for n, _ in spans} == set(PARENTS)
    for name, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    # every range came through the one opener
    assert sorted(profiled["opened"]) == sorted(n for n, _ in spans)


def test_span_counts_follow_the_cycle(profiled):
    count = {}
    for name, _ in profiled["spans"]:
        count[name] = count.get(name, 0) + 1
    steps = profiled["steps"]
    pc = count["alfi.pc_apply"]
    assert pc == sum(st["info"]["linear_iter"] for st in steps)
    assert count["alfi.mg_setup"] == sum(st["info"]["nonlinear_iter"]
                                         for st in steps)
    for child in ("tensors", "patch_inverse", "coarse_factor",
                  "level_assemble"):
        assert count["alfi.mg_setup." + child] == count["alfi.mg_setup"]
    assert count["alfi.re_step"] == len(RES)
    assert count["alfi.transfer_setup"] == len(RES)
    assert count["alfi.fmg"] == 2 * pc
    assert count["alfi.smooth"] == 2 * L * (L + 1) * pc
    assert count["alfi.prolong"] == 2 * (L + L * (L + 1) // 2) * pc
    assert count["alfi.restrict"] == count["alfi.prolong"]
    assert count["alfi.coarse_solve"] == 2 * (L + 1) * pc
    # FGMRES(smoothing) from each smoother: one patch apply an iteration
    smoothing = profiled["solver"].smoothing
    assert count["alfi.patch_apply"] == smoothing * count["alfi.smooth"]
    assert count["alfi.host_read"] == sum(st["reads"] for st in steps)
    # one outer Jacobian action an outer Krylov it (no FGMRES restarts)
    assert count["alfi.jacobian_matvec"] == pc


def test_outer_jacobian_is_the_assembled_action(plain, profiled):
    """almg's outer FGMRES multiplies by the set-up's assembled finest
    level operator plus B^T and B, never by the jvp: one count an action,
    with or without a profiler."""
    for sweep in (plain, profiled):
        for st in sweep["steps"]:
            its = st["info"]["linear_iter"]
            assert st["counts"]["jacobian_assembled"] == its
            assert st["counts"]["jacobian_jvp"] == 0


@pytest.mark.parametrize("restart,maxit", [(30, 500), (4, 500), (20, 20)],
                         ids=["one_cycle", "restarts", "maxit_le_restart"])
def test_fgmres_host_reads_dense(restart, maxit):
    g = torch.Generator().manual_seed(5)
    n = 40
    A = (torch.eye(n, dtype=torch.float64)
         + 0.3 * torch.randn(n, n, generator=g, dtype=torch.float64)
         / n ** 0.5)
    b = torch.randn(n, generator=g, dtype=torch.float64)
    n0 = events.COUNTERS["host_reads"]
    x, info = fgmres(lambda v: A @ v, b, rtol=1e-10, atol=0.0,
                     maxit=maxit, restart=restart)
    assert info["converged"]
    assert torch.linalg.norm(A @ x - b) <= 1e-9 * torch.linalg.norm(b)
    assert (events.COUNTERS["host_reads"] - n0
            == fgmres_reads(info["iters"], restart, maxit))


def test_fgmres_fixed_iterations_read_nothing():
    """The smoother's mode tests nothing: no read, no synchronisation."""
    b = torch.ones(12, dtype=torch.float64)
    n0 = events.COUNTERS["host_reads"]
    fgmres(lambda v: 2.0 * v, b, rtol=0.0, atol=-1.0, maxit=5, restart=5)
    assert events.COUNTERS["host_reads"] == n0


def test_re_step_host_reads_formula(plain):
    s = plain["solver"]
    assert s.nsp  # the cavity's pressure is shifted: one read
    for st in plain["steps"]:
        krylov = 0
        for its, restart, maxit, converged, reads in st["fgmres"]:
            assert converged
            assert reads == fgmres_reads(its, restart, maxit)
            krylov += reads
        # the gamma-free residual's norm and the pressure integral
        expect = krylov + newton_reads(st["newton"]) + 2
        assert st["reads"] == expect, (st["reads"], expect)


def test_reset_clears_the_counter():
    events.COUNTERS["host_reads"] += 3
    events.reset()
    assert events.COUNTERS["host_reads"] == 0


def test_reset_clears_the_jacobian_counters():
    events.COUNTERS["jacobian_assembled"] += 2
    events.COUNTERS["jacobian_jvp"] += 5
    events.reset()
    assert events.COUNTERS == {"host_reads": 0, "jacobian_assembled": 0,
                               "jacobian_jvp": 0, "facet_jacobians": 0,
                               "smoother_graph_captures": 0,
                               "smoother_graph_replays": 0,
                               "smoother_eager_steps": 0}


def test_span_is_one_shared_noop_without_profiler():
    assert events.span("alfi.a") is events.span("alfi.b")


def test_sv_spans_nest_as_the_layers(sv_profiled):
    spans = sv_profiled["spans"]
    parents = dict(PARENTS, **SV_PARENTS)
    assert {n for n, _ in spans} == set(parents)
    for name, parent in spans:
        assert parent in parents[name], (name, parent)
    count = {}
    for name, _ in spans:
        count[name] = count.get(name, 0) + 1
    setups = count["alfi.mg_setup"]
    assert setups == sum(st["info"]["nonlinear_iter"]
                         for st in sv_profiled["steps"])
    assert count["alfi.mg_setup.facet_tensors"] == setups
    # one contraction a smoothed level
    assert count["alfi.mg_setup.facet_contract"] == L * setups
    # each Newton residual, and each step's gamma-free check
    assert count["alfi.burman_residual"] == (count["alfi.residual"]
                                             + len(RES))


def test_facet_jacobians_count_every_levels_interior_facets(sv_profiled):
    """One set-up forms the Burman Jacobians of every interior facet of
    every level: the counter adds that number once a set-up."""
    vmg = sv_profiled["solver"].vmg
    per_setup = sum(len(lev.form.mesh.interior_facets) for lev in vmg.levels)
    assert per_setup == sum(st.facets.nif for st in vmg.stab_facet) > 0
    for st in sv_profiled["steps"]:
        assert (st["counts"]["facet_jacobians"]
                == per_setup * st["info"]["nonlinear_iter"])


def test_pkp0_path_records_no_facet_span_or_count(plain, profiled):
    assert not {n for n, _ in profiled["spans"]} & set(SV_PARENTS)
    for sweep in (plain, profiled):
        for st in sweep["steps"]:
            assert st["counts"]["facet_jacobians"] == 0
