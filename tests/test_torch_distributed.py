"""The distributed almg solve (``alfi_torch/parallel/distributed.py``) on
four gloo ranks on the CPU, f64, against the single-device solve and the
JAX package's shard_map solver: the twins of tests/test_distributed.py.

One spawned 4-rank group (``alfi_torch.parallel.dryrun.spawn_ranks``, a
file store, one torch thread a rank, its own time limit) runs every rank
check of this file (``batch_rank``); the tests read its results:

* the linear step for the pkp0 star Re 10, SUPG Re 1000 and GLS Re 1000
  cases of tests/test_distributed.py, at the state of one single-device
  Newton step from rest: the velocity residual within 5e-13 (relative),
  dz within 1e-9 and the same FGMRES count.  The pressure rows of that
  residual are ~5e-12 (the divergence cancels after a Newton step): the
  port's einsum rounds them differently on a batch of fewer than 64 cells
  (about 1e-18 absolute, 2e-7 of their own norm), so they are held to
  5e-13 of the whole residual's norm;
* the continuation at Re 10: the single-device counts, u within 1e-10
  and p within 1e-8;
* the port's 4-rank dz against the JAX package's DistributedSolver dz on
  the conftest's 8 virtual devices, at the same state: within 1e-9, the
  same count;
* every rank holds the same bits for an owner-weighted dot, the interface
  values after an exchange and the global coarse right-hand side;
* outside a group, a 2-rank group is refused (the twin of
  ``test_make_device_mesh_refuses_truncation``).
"""

import numpy as np
import pytest
import torch

from alfi_torch.parallel import make_rank_group
from alfi_torch.parallel.dryrun import batch_rank, ldc_solver, spawn_ranks

NRANKS = 4
CASES = {
    "pkp0-star": ({}, 10.0),
    "pkp0-supg-re1000": ({"stabilisation_type": "supg"}, 1000.0),
    "pkp0-gls-re1000": ({"stabilisation_type": "gls"}, 1000.0),
}
ORDER = sorted(CASES)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    calls = [("step_rank", CASES[name]) for name in ORDER]
    calls += [("solve_rank", ({}, [10])), ("bits_rank", ({},))]
    return spawn_ranks(batch_rank, NRANKS, args=(calls,), device="cpu",
                       timeout=420)


@pytest.mark.parametrize("name", ORDER)
def test_distributed_linear_step_matches_global(ranks, name):
    res = [r[ORDER.index(name)] for r in ranks]
    ref = res[0]
    Fu, Fp = ref["F_ref"]
    norm_F = np.linalg.norm(np.concatenate([Fu.ravel(), Fp]))
    for r in res:
        assert rel(r["F"][0], Fu) < 5e-13
        assert np.linalg.norm(r["F"][1] - Fp) < 5e-13 * norm_F
        assert r["its"] == ref["its_ref"]
        assert rel(r["dz"][0], ref["dz_ref"][0]) < 1e-9
        assert rel(r["dz"][1], ref["dz_ref"][1]) < 1e-9


def test_distributed_continuation_solve(ranks):
    res = [r[len(ORDER)] for r in ranks]
    single = ldc_solver("cpu")
    _, info_g = single.solve(10)
    for r in res:
        (info,) = r["infos"]
        assert info["converged"]
        assert info["linear_iter"] == info_g["linear_iter"]
        assert info["nonlinear_iter"] == info_g["nonlinear_iter"]
        assert rel(r["state"][0], single.z[0].numpy()) < 1e-10
        assert rel(r["state"][1], single.z[1].numpy()) < 1e-8


def test_distributed_step_matches_the_jax_package(ranks):
    """The same state through the JAX package's DistributedSolver on the
    8 virtual devices: the port's 4-rank dz within 1e-9, the same count."""
    from alfi_tpu import ConstantPressureSolver
    from alfi_tpu.parallel import make_device_mesh
    from alfi_tpu.parallel.distributed import DistributedSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem

    port = ranks[0][ORDER.index("pkp0-star")]
    solver = ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(4), nref=1, k=2, solver_type="almg",
        hierarchy="uniform", patch="star", gamma=1e4, verbose=False)
    solver.advect_val = 1.0
    solver.nu_val = solver.char_L * solver.char_U / 10.0
    solver.z = tuple(port["state"])
    solver.z_last = solver.z
    params = solver.params()
    dist = DistributedSolver(solver, make_device_mesh(8))
    z, _ = dist.shard_state(solver.z, params)
    F, _ = dist.residual(z, params)
    dz, its = dist.linear_step(z, F, params, dist.transfer_setup(params))
    dz = dist.gather_state(dz)
    assert port["its"] == its
    assert rel(port["dz"][0], dz[0]) < 1e-9
    assert rel(port["dz"][1], dz[1]) < 1e-9


def test_every_rank_holds_the_same_bits(ranks):
    res = [r[len(ORDER) + 1] for r in ranks]
    for r in res[1:]:
        assert r["dot"] == res[0]["dot"]
        np.testing.assert_array_equal(r["coarse_rhs"], res[0]["coarse_rhs"])
    # every interface dof: one value on every rank that holds it
    seen = {}
    for r in res:
        for dof, v in zip(r["interface_dofs"], r["interface"]):
            assert seen.setdefault(int(dof), v) == v
    assert len(seen) > 0
    # and the continuation's gathered state is the same on every rank
    states = [r[len(ORDER)]["state"] for r in ranks]
    for s in states[1:]:
        for a, b in zip(s, states[0]):
            np.testing.assert_array_equal(a, b)


def test_make_rank_group_refuses_truncation(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_rank_group(NRANKS, device="cpu")


@pytest.mark.parametrize("case", ["no-cuda", "missing-card",
                                  "wrong-backend"])
def test_make_rank_group_refuses_what_it_cannot_serve(monkeypatch, case):
    """No silent switch: a card request without CUDA, a local rank with no
    card of its own, and a process group that already runs another
    backend than the device needs (gloo, where one rank on one card runs
    under NCCL) raise; the first two before any group is made."""
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    if case == "no-cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_rank_group(2, device="cuda")
        assert not dist.is_initialized()
        return
    # a host with one card, as far as make_rank_group can see
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if case == "missing-card":
        with pytest.raises(RuntimeError, match="no card of its own"):
            make_rank_group(2, device="cuda")
        assert not dist.is_initialized()
        return
    dist.init_process_group("gloo", world_size=1, rank=0,
                            store=dist.HashStore())
    try:
        with pytest.raises(RuntimeError, match="runs gloo"):
            make_rank_group(1, device="cuda:0")
    finally:
        dist.destroy_process_group()
