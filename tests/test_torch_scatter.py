"""The port's scatter-adds in rounds of distinct destinations
(``alfi_torch/fem/scatter.py``), f64 on the CPU.

On the card ``index_add`` sums colliding contributions with float
atomics, so its bits change from run to run; the port sums there by a
gather table and an ordered ``cumsum`` (out of place) or in rounds that
hold no destination twice (in place).  On the CPU the default route is
one ``index_add``; these tests force the card's routes and hold them to
it:

* the table and the rounds of an index: every position exactly once,
  each destination's positions in index order, no destination twice in
  a round;
* both routes give the bits of the CPU's ``index_add`` (1-D and 2-D
  sources, onto zeros and onto old values), and the table passes
  ``torch.func.jvp`` and ``vjp``;
* whole solves by the card's routes give the default route's bits:
  ldc2d [P2]^2-P0 almg and lu, SV with Burman's stabilisation, and the
  3D flux-corrected bubble restriction;
* on the card (marked ``cuda``): two calls give the same bits, and both
  routes those of the CPU's ``index_add``.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver, ScottVogeliusSolver
from alfi_torch.fem.scatter import ScatterAdd, gather_table, round_positions
from alfi_torch.mg.bubble import BubbleTransfer
from alfi_torch.problems import ThreeDimLidDrivenCavityProblem
from alfi_torch.problems import TwoDimLidDrivenCavityProblem


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tables():
    rng = np.random.default_rng(3)
    return {"random": rng.integers(0, 50, size=(400, 3)),
            "one destination": np.zeros(17, dtype=np.int64),
            "distinct": rng.permutation(30),
            "mesh cells": TwoDimLidDrivenCavityProblem(2).mesh_hierarchy(
                "uniform", 0)[0].cells}


@pytest.mark.parametrize("name", ["random", "one destination", "distinct",
                                  "mesh cells"])
def test_table_and_rounds_keep_index_order(name):
    index = np.asarray(_tables()[name]).reshape(-1)
    rounds = round_positions(index)
    seen = np.concatenate(rounds)
    assert np.array_equal(np.sort(seen), np.arange(index.size))
    for pos in rounds:
        assert np.all(np.diff(pos) > 0)
        assert np.unique(index[pos]).size == pos.size
    # destination d's k-th position (in index order) sits in round k
    for k, pos in enumerate(rounds):
        for p in pos:
            assert int((index[:p] == index[p]).sum()) == k
    assert len(rounds) == np.bincount(index).max()
    # the table lists the same positions, per destination in index order
    n = int(index.max()) + 1
    table = gather_table(index, n)
    assert table.shape == (1 + len(rounds), n)
    assert np.array_equal(table[0], np.arange(n))
    for j in range(n):
        live = table[1:, j][table[1:, j] < n + index.size] - n
        assert np.array_equal(live, np.flatnonzero(index == j))


@pytest.mark.parametrize("width", [None, 2])
def test_card_routes_give_the_bits_of_index_add(width):
    rng = np.random.default_rng(7)
    index = rng.integers(0, 40, size=(300, 4))
    shape = (index.size,) if width is None else (index.size, width)
    src = torch.as_tensor(rng.standard_normal(shape))
    base = torch.as_tensor(rng.standard_normal((40,) + shape[1:]))
    sa = ScatterAdd(torch.as_tensor(index), 40)
    want = base.index_add(0, torch.as_tensor(index.reshape(-1)), src)
    assert len(sa.rounds()) > 1
    assert torch.equal(sa.by_table(src, base), want)
    assert torch.equal(sa(src, base), want)
    zero = torch.zeros_like(base)
    assert torch.equal(sa.by_table(src, zero), zero.index_add(
        0, torch.as_tensor(index.reshape(-1)), src))
    inplace = base.clone()
    for pos, dst in sa.rounds():
        inplace.index_add_(0, dst, src[pos])
    assert torch.equal(inplace, want)


def test_table_passes_jvp_and_vjp():
    rng = np.random.default_rng(11)
    index = torch.as_tensor(rng.integers(0, 25, size=200))
    x = torch.as_tensor(rng.standard_normal((200, 3)))
    t = torch.as_tensor(rng.standard_normal((200, 3)))
    g = torch.as_tensor(rng.standard_normal((25, 3)))
    sa = ScatterAdd(index, 25)

    def table(v):
        return sa.by_table(v, v.new_zeros((25, 3)))

    def plain(v):
        return v.new_zeros((25, 3)).index_add(0, index, v)

    assert torch.equal(torch.func.jvp(table, (x,), (t,))[1],
                       torch.func.jvp(plain, (x,), (t,))[1])
    assert torch.equal(torch.func.vjp(table, x)[1](g)[0],
                       torch.func.vjp(plain, x)[1](g)[0])


@pytest.fixture
def card_routes(monkeypatch):
    """Every ScatterAdd sums by its table and its rounds, as it does on
    the card."""
    def call(self, src, out=None):
        if out is None:
            out = src.new_zeros((self.n,) + tuple(src.shape[1:]))
        return self.by_table(src, out)

    def add_(self, out, src):
        for pos, dst in self.rounds():
            out.index_add_(0, dst, src if pos is None else src[pos])
        return out

    def force():
        monkeypatch.setattr(ScatterAdd, "__call__", call)
        monkeypatch.setattr(ScatterAdd, "add_", add_)
    return force


SOLVES = {
    "pkp0 almg": (ConstantPressureSolver, dict(solver_type="almg"),
                  [1, 100]),
    "pkp0 lu": (ConstantPressureSolver, dict(solver_type="lu"), [1, 100]),
    "sv burman": (ScottVogeliusSolver,
                  dict(solver_type="almg", hierarchy="bary", patch="macro",
                       stabilisation_type="burman",
                       stabilisation_weight=5e-3), [1, 100])}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_by_card_routes_gives_the_default_bits(name, card_routes):
    cls, kw, res = SOLVES[name]
    kw = dict(dict(nref=1, k=2, hierarchy="uniform", gamma=1e4,
                   verbose=False), **kw)

    def solve():
        solver = cls(TwoDimLidDrivenCavityProblem(4), device="cpu", **kw)
        out = []
        for re in res:
            z, info = solver.solve(re)
            out.append((z[0].clone(), z[1].clone(), info["linear_iter"],
                        info["nonlinear_iter"]))
        return out

    want = solve()
    card_routes()
    got = solve()
    for (u, p, k, n), (u2, p2, k2, n2) in zip(got, want):
        assert (k, n) == (k2, n2)
        assert torch.equal(u, u2) and torch.equal(p, p2)


def test_bubble_restriction_by_card_routes_gives_the_default_bits(
        card_routes):
    hierarchy = ThreeDimLidDrivenCavityProblem(1).mesh_hierarchy("uniform",
                                                                 1)
    tb = BubbleTransfer(hierarchy, 0, device="cpu")
    n = hierarchy[1].num_vertices + len(hierarchy[1].facet_vertices)
    r = torch.as_tensor(np.random.default_rng(5).standard_normal((n, 3)))
    want = tb.apply_transpose(r)
    card_routes()
    assert torch.equal(tb.apply_transpose(r), want)


@pytest.mark.cuda
def test_scatter_add_on_the_card_repeats_the_cpu_bits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    index = rng.integers(0, 1000, size=(200_000, 3))
    src = torch.as_tensor(rng.standard_normal((index.size, 2)))
    want = torch.zeros((1000, 2), dtype=src.dtype).index_add(
        0, torch.as_tensor(index.reshape(-1)), src)
    sa = ScatterAdd(torch.as_tensor(index, device="cuda"), 1000)
    a, b = sa(src.cuda()), sa(src.cuda())
    c = sa.add_(torch.zeros((1000, 2), dtype=src.dtype, device="cuda"),
                src.cuda())
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want) and torch.equal(c.cpu(), want)
