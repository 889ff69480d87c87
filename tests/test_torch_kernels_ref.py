"""The kernels' plain versions against the JAX package, and the CUDA
kernels against their plain versions (on a card only).

* K2, the level matvec: alfi_torch VelocityMG.level_apply (plain path on
  the CPU) vs alfi_tpu VelocityMG.level_apply, normwise relative 1e-12
  (summation order only).
* K1, the patch apply: explicit f64 inverses (the port) vs the JAX CPU
  path's LU solves, on the gamma=1e4 patch operators whose condition
  numbers reach ~1e8 (docs/DESIGN.md:34-44): normwise relative 1e-7.

The JAX package is imported inside the fixtures, so that the CUDA tests
also run on a GPU host without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_ref.py``.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import kernels
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solvers():
    from alfi_tpu import ConstantPressureSolver as JaxSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

    torch.set_num_threads(1)
    return (TorchSolver(TorchLDC(4), device="cpu", **KW),
            JaxSolver(JaxLDC(4), **KW))


@pytest.fixture(scope="module")
def jnp():
    import jax.numpy

    return jax.numpy


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _wind(solver, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((solver.Z.V.ndof, 2))


def test_level_apply_matches_jax(solvers, jnp):
    t, j = solvers
    rng = np.random.default_rng(11)
    lev = t.vmg.levels[1]
    nc, nld = lev.rows.shape
    T = rng.standard_normal((nc, nld, nld))
    v = rng.standard_normal((lev.V.ndof, 2))
    out_t = t.vmg.level_apply(1, torch.as_tensor(T), torch.as_tensor(v))
    out_j = j.vmg.level_apply(1, jnp.asarray(T), jnp.asarray(v))
    assert _rel(out_t, out_j) < 1e-12


@pytest.mark.parametrize("kind", ["smoother", "schoeberl"])
def test_patch_apply_matches_jax(solvers, jnp, kind):
    t, j = solvers
    w = _wind(t, 3)
    tform, jform = t.vmg.levels[1].form, j.vmg.levels[1].form
    if kind == "smoother":
        (tfac, tapply), (jfac, japply) = (t.vmg.patch_solvers[0],
                                          j.vmg.patch_solvers[0])
        Tt = tform.velocity_element_tensors(PARAMS, torch.as_tensor(w))
        Tj = jform.velocity_element_tensors(PARAMS, jnp.asarray(w))
    else:
        ts, js = t.vmg.schoeberl[0], j.vmg.schoeberl[0]
        tfac, tapply, jfac, japply = ts.factor, ts.papply, js.factor, \
            js.papply
        p0 = dict(PARAMS, advect=0.0)
        Tt = tform.velocity_element_tensors(p0, torch.as_tensor(w))
        Tj = jform.velocity_element_tensors(p0, jnp.asarray(w))
    r = np.random.default_rng(5).standard_normal(
        t.vmg.levels[1].V.ndof * 2)
    out_t = tapply(tfac(Tt), torch.as_tensor(r))
    out_j = japply(jfac(Tj), jnp.asarray(r))
    assert _rel(out_t, out_j) < 1e-7


def test_plain_gather_bgemv_reads_pads_as_zero():
    rng = np.random.default_rng(0)
    nb, m, n = 7, 5, 20
    A = rng.standard_normal((nb, m, m))
    x = rng.standard_normal(n)
    idx = rng.integers(-3, n + 3, size=(nb, m))
    xg = np.where((idx >= 0) & (idx < n), x[np.clip(idx, 0, n - 1)], 0.0)
    ref = np.einsum("bij,bj->bi", A, xg)
    out = kernels.gather_bgemv(torch.as_tensor(A), torch.as_tensor(x),
                               torch.as_tensor(idx, dtype=torch.int32),
                               "K1")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-14, atol=1e-14)


def test_csr_segment_sum_is_the_scatter_adjoint():
    rng = np.random.default_rng(1)
    nb, m, n = 9, 4, 15
    idx = rng.integers(0, n + 2, size=(nb, m))  # n, n+1 are pads
    offsets, slots = kernels.csr_from_table(idx, n)
    vals = rng.standard_normal((nb, m))
    ref = np.zeros(n)
    keep = idx < n
    np.add.at(ref, idx[keep], vals[keep])
    out = kernels.csr_segment_sum(torch.as_tensor(vals),
                                  torch.as_tensor(offsets),
                                  torch.as_tensor(slots), "K1")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-14, atol=1e-14)
    # the list runs in ascending slot order within each dof
    for k in range(n):
        seg = slots[offsets[k]:offsets[k + 1]]
        assert np.all(np.diff(seg) > 0)


def test_cpu_tensors_never_count_launches():
    kernels.reset_launch_counts()
    op = kernels.GatherGemvScatter(np.array([[0, 1], [1, 2]]), 3, "K2",
                                   device="cpu")
    A = torch.ones((2, 2, 2), dtype=torch.float64)
    out = op(A, torch.ones(3, dtype=torch.float64))
    np.testing.assert_array_equal(out.numpy(), [2.0, 4.0, 2.0])
    assert kernels.gather_bgemv.launches == {"K1": 0, "K2": 0}
    assert kernels.csr_segment_sum.launches == {"K1": 0, "K2": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4225, 14), (2048, 6), (8192, 12),
                                   (300, 64)])
def test_cuda_kernels_match_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    nb, m = shape
    n = nb * m // 3
    rng = np.random.default_rng(0)
    idx = rng.integers(0, n + 1, size=(nb, m))  # n is the pad
    op = kernels.GatherGemvScatter(idx, n, "K1", device=dev)
    A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev)
    x = torch.as_tensor(rng.standard_normal(n), device=dev)
    before = kernels.gather_bgemv.launches["K1"]
    yk, yp = op(A, x), op.plain(A, x)
    torch.cuda.synchronize()
    assert kernels.gather_bgemv.launches["K1"] == before + 1
    err = float((yk - yp).abs().max() / yp.abs().max())
    assert err <= 1e-13
    with pytest.raises(ValueError):
        kernels.gather_bgemv(A[:, :, :1].contiguous(), x, op.idx, "K1")
