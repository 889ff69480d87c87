"""The state reader on the CPU: the port's Scott-Vogelius state ([P2]^2-
P1disc on a barycentric mesh, three pressure dofs to a cell at points that
neighbouring cells share) read exactly through a reference that states only
per-cell nodes; the faults that stop a check still stop it; and on both
configurations of the benchmark the reader's permutations are those of the
point-by-point match it replaced."""

import types

import numpy as np
import pytest
import torch

from benchmark.harness import answers, check, registry
from benchmark.harness.system import System
from conftest import small_3d_config, small_config

#: alfi's Makefile target iters2dsv, cut to ldc2d baseN 4, nref 1 (2,754
#: dofs)
SV_FLAGS = ["--discretisation", "sv", "--mh", "bary", "--patch", "macro",
            "--stabilisation-type", "burman", "--stabilisation-weight",
            "5e-3", "--restriction", "--k", "2", "--baseN", "4", "--nref",
            "1"]
#: the uniform mesh's spacing under the barycentric refinement
SV_SPACING = 2.0 / 8


def old_match(program_coords, reference_coords, step):
    """The point-by-point match the reader used for both fields before it
    read a pressure dof by its cell: the oracle of its permutations."""
    def keys(coords):
        r = np.round(np.asarray(coords, dtype=np.float64) / step)
        r = r.astype(np.int64)
        base = int(r.max(initial=0)) + 1
        return r @ (base ** np.arange(r.shape[1], dtype=np.int64))

    kp, kr = keys(program_coords), keys(reference_coords)
    op = np.argsort(kp, kind="stable")
    orr = np.argsort(kr, kind="stable")
    assert np.array_equal(kp[op], kr[orr])
    perm = np.empty(len(kr), dtype=np.int64)
    perm[orr] = op
    return perm


class CellNodes:
    """A test double of a reference's ``Reference`` for [P2]^2-P1disc,
    built from the mesh alone: its cells in a shuffled order, each cell's
    vertices (its pressure nodes) in a shuffled order, its velocity nodes
    (vertices and edge midpoints) shuffled.  ``order[i]`` is the mesh's
    cell that is its cell i."""

    def __init__(self, vertices, cells, spec=None, device="cpu", seed=0):
        rng = np.random.default_rng(seed)
        self.order = rng.permutation(len(cells))
        x = vertices[rng.permuted(cells[self.order], axis=1)]
        self.pressure_nodes = x
        self.cell_centroids = x.mean(axis=1)
        step = SV_SPACING / 6
        mids = (x + x[:, [1, 2, 0]]) / 2
        pts = np.concatenate([vertices, mids.reshape(-1, 2)])
        lat = np.unique(np.round(pts / step).astype(np.int64), axis=0)
        self.node_coords = rng.permutation(lat) * step

    def residual_norm(self, u, p, re):
        return 0.0


@pytest.fixture(scope="module")
def sv():
    torch.set_num_threads(1)
    system = System({"problem": {"class": "TwoDimLidDrivenCavityProblem",
                                 "args": {"baseN": 4}},
                     "flags": SV_FLAGS}, "cpu")
    mesh = system.mesh()
    nodes = system.node_coords() + (system.pressure_cell_dofs(),)
    return mesh, nodes


def _lattice(x, step):
    return np.round(np.asarray(x) / step).astype(np.int64)


def test_reads_the_sv_pressure_exactly(sv):
    mesh, (u_coords, p_coords, cell_dofs) = sv
    nc = len(mesh[1])
    # three dofs a cell, at points that neighbouring cells share: no match
    # by point alone can read them
    assert cell_dofs.shape == (nc, 3) and len(p_coords) == 3 * nc
    assert len(np.unique(_lattice(p_coords, SV_SPACING / 12), axis=0)) \
        < len(p_coords) // 4
    with pytest.raises(ValueError):
        answers.match(p_coords, p_coords, SV_SPACING / answers.LATTICE)

    ref = CellNodes(*mesh)
    read = answers.StateReader(ref, mesh, sv[1], SV_SPACING)
    # a field that jumps between cells: the owning cell's index, plus a
    # linear function of the point, in whole numbers so that it is exact
    owner = np.empty(len(p_coords), dtype=np.int64)
    owner[cell_dofs] = np.arange(nc)[:, None]
    lp = _lattice(p_coords, SV_SPACING / 12)
    p = (1000 * owner + lp[:, 0] + 37 * lp[:, 1]).astype(np.float64)
    lu = _lattice(u_coords, SV_SPACING / 6)
    u = lu.astype(np.float64)
    ur, pr = read(u, p)

    lr = _lattice(ref.pressure_nodes, SV_SPACING / 12)
    want = 1000 * ref.order[:, None] + lr[..., 0] + 37 * lr[..., 1]
    assert pr.shape == (3 * nc,)
    assert np.array_equal(pr.reshape(nc, 3), want)
    assert np.array_equal(ur, _lattice(ref.node_coords, SV_SPACING / 6))


def _missing_node(ref):
    ref.pressure_nodes[5, 1] = ref.cell_centroids[5]


def _off_lattice(ref):
    ref.pressure_nodes[5, 1] += SV_SPACING / 1000


def _repeated_node(ref):
    ref.pressure_nodes[5, 2] = ref.pressure_nodes[5, 0]


def _missing_cell(ref):
    ref.pressure_nodes = ref.pressure_nodes[1:]
    ref.cell_centroids = ref.cell_centroids[1:]


def _one_node_a_cell(ref):
    del ref.pressure_nodes


@pytest.mark.parametrize("fault", [_missing_node, _off_lattice,
                                   _repeated_node, _missing_cell,
                                   _one_node_a_cell])
def test_a_fault_still_stops_the_reader(sv, fault):
    mesh, nodes = sv
    ref = CellNodes(*mesh)
    answers.StateReader(ref, mesh, nodes, SV_SPACING)
    fault(ref)
    with pytest.raises(ValueError):
        answers.StateReader(ref, mesh, nodes, SV_SPACING)


def test_a_node_repeated_in_one_cell_is_refused(sv):
    """Even where both sides repeat it: which dof is which is then left
    open."""
    _, (_, p_coords, cell_dofs) = sv
    x = p_coords[cell_dofs]
    answers.match_rows(x, x.copy(), SV_SPACING / 12)
    x[5, 2] = x[5, 0]
    with pytest.raises(ValueError):
        answers.match_rows(x, x.copy(), SV_SPACING / 12)


def test_a_dof_in_two_cells_is_refused(sv):
    """A continuous P1 pressure on the same mesh: every cell's nodes are
    the reference's, but its dofs are not one to a reference node."""
    (vertices, cells), (u_coords, _, _) = sv
    nodes = (u_coords, vertices, cells)
    with pytest.raises(ValueError):
        answers.StateReader(CellNodes(vertices, cells), (vertices, cells),
                            nodes, SV_SPACING)


@pytest.mark.parametrize("d,divisors", [
    (2, [2, 3, 6, 9]),         # P2 and P3 nodes, barycentres, sub-cells
    (3, [2, 4, 8, 12, 16])])   # the same on a 3D barycentric mesh
def test_the_lattice_holds_every_roadmap_node(d, divisors):
    """Points on each of the divisors' lattices of h lie on the one lattice
    and keep distinct keys within int64, at 288 cells a side in 3D (alfi's
    largest 3D row, baseN 18, nref 4) and 2048 in 2D; a point between two
    of its steps lies off it."""
    n = 288 if d == 3 else 2048
    h = 1.0 / n
    rng = np.random.default_rng(0)
    pts = [rng.integers(0, n * q + 1, size=(500, d)) * (h / q)
           for q in divisors]
    pts.append(np.full((1, d), 1.0))
    keys = answers.lattice_keys(*pts, step=h / answers.LATTICE)
    want = np.unique(np.round(np.concatenate(pts) * n * answers.LATTICE),
                     axis=0)
    assert len(np.unique(np.concatenate(keys))) == len(want)
    with pytest.raises(ValueError):
        answers.lattice_keys(pts[0] + h / 288, step=h / answers.LATTICE)


@pytest.mark.parametrize("broken", [False, True], ids=["read", "unread"])
def test_an_unread_state_counts_unjudged(sv, monkeypatch, broken):
    mesh, nodes = sv

    def reference(vertices, cells, spec, device):
        ref = CellNodes(vertices, cells)
        if broken:
            _missing_node(ref)
        return ref

    module = types.SimpleNamespace(check_mesh=lambda *a: None,
                                   Reference=reference)
    monkeypatch.setattr(registry, "reference", lambda name: module)
    config = {"reference": {"module": "cell_nodes", "extent": 2.0,
                            "cells_per_side": 8},
              "check": {"residual_max": 1e-4}}
    steps = [(1.0, torch.zeros(len(nodes[0]), 2),
              torch.zeros(len(nodes[1])))] * 3
    correct, numbers, _ = check.judge(config, mesh, nodes, steps)
    assert correct is not broken
    assert numbers["steps_unjudged"]["value"] == (3 if broken else 0)


@pytest.mark.parametrize("make", [small_config, small_3d_config],
                         ids=["ldc2d_p2p0", "ldc3d_p1fb_supg"])
def test_permutations_are_the_old_matchs(make):
    torch.set_num_threads(1)
    cfg = make()
    system = System(cfg, "cpu")
    mesh = system.mesh()
    nodes = system.node_coords() + (system.pressure_cell_dofs(),)
    judge = check.Judge(cfg, mesh, nodes, "cpu")
    assert judge.error is None
    h = float(cfg["reference"]["extent"]) / cfg["reference"]["cells_per_side"]
    ref = judge.ref
    assert np.array_equal(judge.read.u_perm,
                          old_match(nodes[0], ref.node_coords, h / 6.0))
    assert np.array_equal(judge.read.p_perm,
                          old_match(nodes[1], ref.cell_centroids, h / 12.0))
