"""The FGMRES smoother's Arnoldi workspace and its CUDA graphs
(``alfi_torch/solvers/krylov.py:Arnoldi``, ``GraphCapture``;
``VelocityMG._smooth``).

On the card the fixed-iteration mode runs its vector work in a workspace
kept per multigrid level and dtype for the solver's life, whose buffers
lie in one arena that the levels share; each stage (start, Arnoldi step
j, solution) is a CUDA graph, with the patch apply (K1) and the level
apply (KM) launched eagerly between replays.  The
stages run the same operations in the same order as the loop they
replace, kept below as ``_reference_fgmres``, so the states are held to
it bit for bit:

* on the CPU, f64: the fixed mode through a workspace (fresh, and reused
  with stale buffers) gives the reference's bits for m = 6 and m = 10 on
  the finest level of [P2]^2-P0 (2D), [P1+FB]^3-P0 (3D, face bubbles) and
  Scott-Vogelius (macrostar patches, Burman), from a guess and from zero,
  and the smoother counts its steps as eager, capturing nothing;
* the converging mode (the outer FGMRES, restarts, a projector, tuple
  vectors) gives the reference's bits;
* on the CPU the smoother keeps no workspace, and a workspace refuses
  what it does not fit;
* on the card (marked ``cuda``): graphed equals eager equals the
  reference bit for bit at the same shapes, a smooth makes no host
  synchronisation (``torch.cuda.set_sync_debug_mode("error")``), the
  shared arena lies at one address and is freed when the smooth returns,
  what a smooth returns outlives later replays, the memory the graphs
  keep is one arena and a graph pool that stop growing after the first
  linear step, and the workspaces are made once per level and dtype at
  the first linear step, whose graphs the next step replays.

This file imports no JAX, so its card tests run on a host without it:
``python -m pytest --noconftest -m cuda tests/test_torch_smoother_graphs.py``.
"""

from types import SimpleNamespace

import pytest
import torch

from alfi_torch import ConstantPressureSolver, ScottVogeliusSolver
from alfi_torch.mg.velocity import VelocityMG
from alfi_torch.problems import (ThreeDimLidDrivenCavityProblem,
                                 TwoDimLidDrivenCavityProblem)
from alfi_torch.solvers.krylov import (_EPS, Arnoldi, GraphCapture,
                                       ShardDotContext, _buf_axpy,
                                       _buf_dots, _get, _identity, _set,
                                       _stack_zeros, fgmres)
from alfi_torch.utils import events
from alfi_torch.utils.tree import leaves, tmap, tnorm, tscale, tsub
from alfi_torch.utils.tree import tzeros_like

KW = dict(nref=1, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
DISCS = ["pkp0_2d", "pkp0_3d_fb", "sv_macro"]
COUNTS = ("smoother_graph_captures", "smoother_graph_replays",
          "smoother_eager_steps")


def _reference_fgmres(A, b, pc=None, x0=None, rtol=1e-9, atol=1e-10,
                      maxit=500, restart=30, project=None):
    """The loop the workspace replaced, verbatim but for its host reads
    (plain floats here) and the distributed dot context (none)."""
    if pc is None:
        pc = _identity
    if project is None:
        project = _identity
    zero_guess = x0 is None
    if zero_guess:
        x0 = tzeros_like(b)
    b = project(b)
    m = restart
    fixed = rtol == 0.0 and atol < 0.0
    ref = leaves(b)[0]
    vdt = ref.dtype
    for x in leaves(b)[1:]:
        vdt = torch.promote_types(vdt, x.dtype)

    def opA(v):
        return project(A(v))

    r0 = b if zero_guess else tsub(b, opA(x0))
    rnorm0 = tnorm(r0)
    target = None if fixed else max(rtol * float(rnorm0), atol)

    def cgs2(V, w, n):
        h1 = _buf_dots(V, w, n)
        w = _buf_axpy(V, h1, w)
        h2 = _buf_dots(V, w, n)
        w = _buf_axpy(V, h2, w)
        return w, h1 + h2

    def cycle(x, total_it, r=None):
        if r is None:
            r = tsub(b, opA(x))
        beta = tnorm(r)
        V = _stack_zeros(b, m + 1)
        _set(V, 0, tscale(1.0 / (beta + _EPS), r))
        Z = _stack_zeros(b, m)
        R = torch.zeros((m + 1, m), dtype=vdt, device=ref.device)
        rot = torch.zeros((m, 2, 2), dtype=vdt, device=ref.device)
        g = torch.zeros((m + 1,), dtype=vdt, device=ref.device)
        g[0] = beta
        j = 0
        rnorm = beta
        while (j < m and total_it + j < maxit
               and (fixed or float(rnorm) > target)):
            z = pc(_get(V, j, b))
            _set(Z, j, z)
            w = opA(z)
            w, h = cgs2(V, w, j + 1)
            hj1 = tnorm(w)
            _set(V, j + 1, tscale(1.0 / (hj1 + _EPS), w))
            hcol = torch.zeros((m + 1,), dtype=vdt, device=ref.device)
            hcol[:j + 1] = h
            hcol[j + 1] = hj1
            for i in range(j):
                hcol[i:i + 2] = rot[i] @ hcol[i:i + 2]
            a_, b_ = hcol[j], hcol[j + 1]
            denom = torch.sqrt(a_ * a_ + b_ * b_) + _EPS
            c_new, s_new = a_ / denom, b_ / denom
            rot[j] = torch.stack([torch.stack([c_new, s_new]),
                                  torch.stack([-s_new, c_new])])
            hcol[j] = denom
            hcol[j + 1] = 0.0
            R[:, j] = hcol
            gj = g[j].clone()
            g[j] = c_new * gj
            g[j + 1] = -s_new * gj
            rnorm = torch.abs(g[j + 1])
            j += 1
        if j:
            y = torch.linalg.solve_triangular(
                R[:j, :j], g[:j, None], upper=True)[:, 0]
            x = tmap(lambda xx, zz: xx + torch.tensordot(y, zz[:j], dims=1),
                     x, Z if isinstance(x, tuple) else Z[0])
        return x, total_it + j, rnorm

    if maxit <= restart:
        x, iters, rnorm = cycle(x0, 0, r0)
    else:
        x, iters, rnorm = x0, 0, rnorm0
        r = r0 if zero_guess else None
        while float(rnorm) > target and iters < maxit:
            x, iters, rnorm = cycle(x, iters, r)
            r = None
    return x, {"iters": iters, "rnorm": rnorm, "rnorm0": rnorm0}


def _make(disc, device):
    if disc == "pkp0_2d":
        return ConstantPressureSolver(TwoDimLidDrivenCavityProblem(4), k=2,
                                      device=device, **KW)
    if disc == "pkp0_3d_fb":
        return ConstantPressureSolver(ThreeDimLidDrivenCavityProblem(2),
                                      k=1, device=device, **KW)
    return ScottVogeliusSolver(
        TwoDimLidDrivenCavityProblem(2), device=device,
        **dict(KW, k=2, hierarchy="bary", patch="macro",
               stabilisation_type="burman"))


def _level(disc, device):
    """(solver, its MG set-up's state, the finest level's operator,
    patch PC, a right-hand side and a guess), seeded."""
    torch.set_num_threads(1)
    s = _make(disc, device)
    s.advect_val = 1.0
    s.nu_val = s.char_L * s.char_U / 100.0
    params = s.params()
    g = torch.Generator().manual_seed(11)
    u = 1e-2 * torch.randn(s.z[0].shape, generator=g, dtype=torch.float64)
    p = 1e-2 * torch.randn(s.z[1].shape, generator=g, dtype=torch.float64)
    state = s.vmg.setup(u.to(device), params,
                        schoeberl_state=s._transfer_setup(params),
                        static=s._almg_static, p_fine=p.to(device))
    vmg, L = s.vmg, s.vmg.nlevels - 1
    vals = state["level_ops"][L]
    mask = vmg.levels[L].mask(torch.float64)
    shape = (vmg.levels[L].V.ndof, vmg.d)
    b = torch.randn(shape, generator=g, dtype=torch.float64)
    x0 = torch.randn(shape, generator=g, dtype=torch.float64)
    return dict(solver=s, state=state, L=L,
                A=lambda v: vmg.level_apply(L, vals, v),
                pc=vmg._smoother_pc(L, state),
                b=mask * b.to(device), x0=mask * x0.to(device))


@pytest.fixture(scope="module")
def levels():
    cache = {}

    def get(disc):
        if disc not in cache:
            cache[disc] = _level(disc, "cpu")
        return cache[disc]

    return get


def _fixed(lv, m, x0, workspace=None):
    return fgmres(lv["A"], lv["b"], pc=lv["pc"], x0=x0, rtol=0.0,
                  atol=-1.0, maxit=m, restart=m, workspace=workspace)


def _counts():
    return {k: events.COUNTERS[k] for k in COUNTS}


def _moved(before):
    return {k: events.COUNTERS[k] - before[k] for k in COUNTS}


@pytest.mark.parametrize("m", [6, 10])
@pytest.mark.parametrize("disc", DISCS)
def test_fixed_mode_workspace_bit_equal_to_the_eager_loop(levels, disc, m):
    lv = levels(disc)
    A, pc, b = lv["A"], lv["pc"], lv["b"]
    ws = Arnoldi(b, m)
    for x0 in (lv["x0"], None, 2.0 * lv["x0"]):
        want, winfo = _reference_fgmres(A, b, pc=pc, x0=x0, rtol=0.0,
                                        atol=-1.0, maxit=m, restart=m)
        # a fresh workspace, then the same one reused (stale buffers)
        for workspace in (None, ws):
            x, info = _fixed(lv, m, x0, workspace)
            assert torch.equal(x, want)
            assert torch.equal(info["rnorm"], winfo["rnorm"])
            assert torch.equal(info["rnorm0"], winfo["rnorm0"])
            assert info["iters"] == m and info["converged"] is None


@pytest.mark.parametrize("disc", DISCS)
def test_smoother_counts_eager_steps_and_captures_nothing(levels, disc):
    """On the CPU the smoother keeps no workspace: each smooth runs
    eagerly in buffers of its own, counted as eager steps."""
    lv = levels(disc)
    vmg, state, L = lv["solver"].vmg, lv["state"], lv["L"]
    m = vmg.smoothing
    want, _ = _reference_fgmres(lv["A"], lv["b"], pc=lv["pc"], x0=lv["x0"],
                                rtol=0.0, atol=-1.0, maxit=m, restart=m)
    before = _counts()
    for _ in range(2):
        assert torch.equal(vmg._smooth(L, state, lv["b"], lv["x0"]), want)
    assert _moved(before) == {"smoother_graph_captures": 0,
                              "smoother_graph_replays": 0,
                              "smoother_eager_steps": 2 * m}
    assert vmg._arnoldi(L, lv["b"]) is None and vmg._graphs is None


@pytest.mark.parametrize("restart,maxit", [(30, 500), (4, 500), (20, 20)],
                         ids=["one_cycle", "restarts", "maxit_le_restart"])
def test_converging_mode_bit_equal_to_the_eager_loop(restart, maxit):
    """The outer FGMRES (tuple vectors, a projector, restarts) shares
    the workspace's stages, run eagerly: the same bits and counts."""
    g = torch.Generator().manual_seed(5)
    n, k = 30, 6
    M = (torch.eye(n + k, dtype=torch.float64)
         + 0.3 * torch.randn(n + k, n + k, generator=g, dtype=torch.float64)
         / (n + k) ** 0.5)
    D = 1.0 + torch.rand(n + k, generator=g, dtype=torch.float64)

    def A(v):
        y = M @ torch.cat([v[0].reshape(-1), v[1]])
        return (y[:n].reshape(-1, 2), y[n:])

    def pc(v):
        return (v[0] / D[:n].reshape(-1, 2), v[1] / D[n:])

    def project(v):
        return (v[0], v[1] - v[1].mean())

    b = (torch.randn(n // 2, 2, generator=g, dtype=torch.float64),
         torch.randn(k, generator=g, dtype=torch.float64))
    for x0 in (None, tmap(lambda t: 0.1 * t, b)):
        kw = dict(pc=pc, x0=x0, rtol=1e-10, atol=0.0, maxit=maxit,
                  restart=restart, project=project)
        x, info = fgmres(A, b, **kw)
        want, winfo = _reference_fgmres(A, b, **kw)
        assert info["converged"]
        assert info["iters"] == winfo["iters"]
        assert all(torch.equal(p, q) for p, q in zip(x, want))
        assert torch.equal(info["rnorm"], winfo["rnorm"])


def test_workspace_refuses_what_it_does_not_fit():
    b = torch.ones(8, dtype=torch.float64)
    ws = Arnoldi(b, 4)
    with pytest.raises(ValueError):  # more steps than it holds
        fgmres(lambda v: v, b, rtol=0.0, atol=-1.0, maxit=5, restart=5,
               workspace=ws)
    with pytest.raises(ValueError):  # another shape
        fgmres(lambda v: v, torch.ones(9, dtype=torch.float64), rtol=0.0,
               atol=-1.0, maxit=4, restart=4, workspace=ws)
    with pytest.raises(ValueError):  # the converging mode
        fgmres(lambda v: v, b, maxit=4, restart=4, workspace=ws)
    with pytest.raises(ValueError):  # another dtype
        fgmres(lambda v: v, b.float(), rtol=0.0, atol=-1.0, maxit=4,
               restart=4, workspace=ws)
    with pytest.raises(ValueError):  # a tuple
        fgmres(lambda v: v, (b, b), rtol=0.0, atol=-1.0, maxit=4,
               restart=4)
    with pytest.raises(ValueError):  # a dot context
        Arnoldi(b, 4, ctx=ShardDotContext(b, None), capture=object())
    # a capture's arena smaller than the workspace's buffers
    small = SimpleNamespace(nbytes=Arnoldi.nbytes(b.shape, b.dtype, 4) - 1)
    with pytest.raises(ValueError):
        Arnoldi(b, 4, capture=small)


def _linear_step(s, made):
    """One Newton linear step of ``s`` (at Re 10), appending to ``made``
    the (level, dtype) of every Arnoldi workspace its smoothers make:
    its Krylov count."""
    real = VelocityMG._arnoldi

    def count(vmg):
        return 0 if vmg._graphs is None else len(vmg._graphs.workspaces)

    def recorded(vmg, l, b):
        n = count(vmg)
        ws = real(vmg, l, b)
        if count(vmg) > n:
            made.append((l, b.dtype))
        return ws

    s.advect_val = 1.0
    s.nu_val = s.char_L * s.char_U / 10.0
    params = s.params()
    F = s.residual_masked(s.z, params)
    VelocityMG._arnoldi = recorded
    try:
        return s._linear_step(s.z, F, params, s._transfer_setup(params))[1]
    finally:
        VelocityMG._arnoldi = real


def test_cpu_linear_step_keeps_no_workspace():
    torch.set_num_threads(1)
    s = _make("pkp0_2d", "cpu")
    before, made = _counts(), []
    its = _linear_step(s, made)
    moved = _moved(before)
    assert its > 0 and made == [] and s.vmg._graphs is None
    assert moved["smoother_graph_captures"] == 0
    assert moved["smoother_graph_replays"] == 0
    assert moved["smoother_eager_steps"] > 0
    assert moved["smoother_eager_steps"] % s.vmg.smoothing == 0


# ----------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_levels(card):
    cache = {}

    def get(disc):
        if disc not in cache:
            cache[disc] = _level(disc, card)
        return cache[disc]

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6, 10])
@pytest.mark.parametrize("disc", DISCS)
def test_graphed_bit_equal_to_eager_on_the_card(card, card_levels, disc, m):
    lv = card_levels(disc)
    A, pc, b = lv["A"], lv["pc"], lv["b"]
    ws = GraphCapture(card, Arnoldi.nbytes(b.shape, b.dtype, m)).workspace(
        "level", b, m)
    before = _counts()
    rounds = 0
    for x0 in (lv["x0"], None, 2.0 * lv["x0"], lv["x0"], None):
        want, winfo = _reference_fgmres(A, b, pc=pc, x0=x0, rtol=0.0,
                                        atol=-1.0, maxit=m, restart=m)
        eager, _ = _fixed(lv, m, x0)
        graphed, info = _fixed(lv, m, x0, ws)
        rounds += 1
        torch.cuda.synchronize()
        assert torch.equal(eager, want)
        assert torch.equal(graphed, want)
        assert torch.equal(info["rnorm"], winfo["rnorm"])
    moved = _moved(before)
    # one start, m steps and one solution: captured once, replayed by
    # every call; the eager calls count their steps
    assert moved["smoother_graph_captures"] == m + 2
    assert moved["smoother_graph_replays"] == rounds * (m + 2)
    assert moved["smoother_eager_steps"] == rounds * m


@pytest.mark.cuda
@pytest.mark.parametrize("disc", DISCS)
def test_a_smooth_on_the_card_never_waits_for_the_host(card, card_levels,
                                                       disc):
    lv = card_levels(disc)
    vmg, L, state = lv["solver"].vmg, lv["L"], lv["state"]
    vmg._graphs = None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # the first smooth captures, the next replay
        xs = [vmg._smooth(L, state, lv["b"], x0)
              for x0 in (lv["x0"], None, lv["x0"])]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(xs[0], xs[2])


@pytest.mark.cuda
def test_capture_and_replay_under_the_profiler(card, card_levels):
    """A traced run captures and replays as an untraced one: the same
    bits, and the replays on the profiler's record."""
    lv = card_levels("pkp0_2d")
    vmg, L, state = lv["solver"].vmg, lv["L"], lv["state"]
    m = vmg.smoothing
    want, _ = _fixed(lv, m, lv["x0"])
    vmg._graphs = None
    before = _counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        xs = [vmg._smooth(L, state, lv["b"], lv["x0"]) for _ in range(2)]
        torch.cuda.synchronize()
    assert all(torch.equal(x, want) for x in xs)
    moved = _moved(before)
    assert moved["smoother_graph_captures"] == m + 2
    assert moved["smoother_graph_replays"] == 2 * (m + 2)
    launches = {e.key: e.count for e in prof.key_averages()}
    assert launches.get("cudaGraphLaunch") == 2 * (m + 2)


@pytest.mark.cuda
def test_card_smooth_holds_no_memory_after_it_returns(card, card_levels):
    """The shared arena lies at one address at every smooth and is freed
    when the smooth returns: the allocator then counts only the result
    the smooth returned."""
    lv = card_levels("pkp0_3d_fb")
    vmg, L, state = lv["solver"].vmg, lv["L"], lv["state"]
    vmg._graphs = None
    x = vmg._smooth(L, state, lv["b"], lv["x0"])  # captures
    graphs = vmg._graphs
    ws = graphs.workspaces[(L, torch.float64)]
    ptr, held = graphs.ptr, _counts()
    for x0 in (None, lv["x0"]):
        del x
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        x = vmg._smooth(L, state, lv["b"], x0)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        assert grown == -(-x.nbytes // 512) * 512
        assert graphs.ptr == ptr and ws.V is None
    moved = _moved(held)
    assert moved["smoother_graph_captures"] == 0
    assert moved["smoother_graph_replays"] == 2 * (vmg.smoothing + 2)


@pytest.mark.cuda
def test_what_a_captured_smooth_returns_outlives_later_replays(card,
                                                              card_levels):
    """The result and both norms are tensors of their own: the replays
    of another workspace of the same capture leave them as they were."""
    lv = card_levels("pkp0_2d")
    A, pc, b = lv["A"], lv["pc"], lv["b"]
    graphs = GraphCapture(card, Arnoldi.nbytes(b.shape, b.dtype, 10))
    first, other = (graphs.workspace(m, b, m) for m in (6, 10))
    want, winfo = _reference_fgmres(A, b, pc=pc, x0=lv["x0"], rtol=0.0,
                                    atol=-1.0, maxit=6, restart=6)
    x, info = _fixed(lv, 6, lv["x0"], first)
    for x0 in (None, 2.0 * lv["x0"], None):
        _fixed(lv, 10, x0, other)
    torch.cuda.synchronize()
    assert torch.equal(x, want)
    assert torch.equal(info["rnorm"], winfo["rnorm"])
    assert torch.equal(info["rnorm0"], winfo["rnorm0"])


def _segment(nbytes):
    """The segment the caching allocator makes for one request."""
    mib = 1 << 20
    if nbytes <= mib:
        return 2 * mib
    if nbytes < 10 * mib:
        return 20 * mib
    return -(-nbytes // (2 * mib)) * 2 * mib


@pytest.mark.cuda
def test_card_smoother_keeps_one_arena_and_stops_growing(card):
    """What the graphs keep that the allocated count leaves out: the
    arena's pool is one segment, the finest level's arena as the
    allocator rounds it, and after the first linear step neither it, nor
    the graphs' pool, nor the device's reserved memory grows."""
    s = _make("pkp0_2d", card)
    made = []
    _linear_step(s, made)
    graphs = s.vmg._graphs

    def pools():
        torch.cuda.synchronize()
        out = {}
        for seg in torch.cuda.memory_snapshot():
            out.setdefault(tuple(seg["segment_pool_id"]), []).append(
                seg["total_size"])
        return (out.get(tuple(graphs.arena_pool.id), []),
                sum(out.get(tuple(graphs.pool), [])),
                torch.cuda.memory_reserved())

    arena, kept, reserved = pools()
    assert arena == [_segment(graphs.nbytes)] and kept > 0
    for _ in range(2):
        _linear_step(s, made)
        assert pools()[:2] == (arena, kept)
        assert pools()[2] <= reserved


@pytest.mark.cuda
def test_card_workspaces_kept_and_replayed_across_linear_steps(card):
    s = _make("pkp0_2d", card)
    before, made = _counts(), []
    first = _linear_step(s, made)
    steps = s.vmg.smoothing
    levels = s.vmg.nlevels - 1
    assert sorted(made) == [(l, torch.float64) for l in range(1, levels + 1)]
    moved = _moved(before)
    assert moved["smoother_eager_steps"] == 0
    assert moved["smoother_graph_captures"] == levels * (steps + 2)
    # the next step captures nothing and replays every stage of every
    # smooth: one start, the steps and one solution
    held = _counts()
    second = _linear_step(s, made)
    moved = _moved(held)
    assert len(made) == levels and second == first
    assert moved["smoother_graph_captures"] == 0
    assert moved["smoother_eager_steps"] == 0
    assert moved["smoother_graph_replays"] > 0
    assert moved["smoother_graph_replays"] % (steps + 2) == 0
