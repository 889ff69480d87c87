"""The port's multiplicative patch sweeps against the JAX package, f64 on
the CPU, ldc2d [P2]^2-P0 baseN=4 nref=1 (the configuration of
tests/test_almg.py::test_almg_multiplicative_sweep) and the 3D cavity
baseN=2 nref=1:

* the host half: ``direction_order`` and ``color_patchset`` equal the
  JAX package's on every smoother level; the colour-ordered PatchSet is a
  permutation of the patches, and no two patches of a colour share a dof
  (each colour table's CSR lists hold at most one slot);
* one symmetrised sweep of ``MultiplicativeSweep`` against the JAX
  package's ``build_multiplicative_solver`` apply on the same cell
  tensors (1e-7: explicit inverses in the port, LU solves in the JAX CPU
  path);
* the twin of test_almg_multiplicative_sweep: Re 100 from rest with the
  JAX counts, the state within 1e-8;
* on the card (marked cuda, skipped without one): the colour tables
  through the pair kernel (2D, m = 14) and the strided kernel (3D, m =
  189) against the same sweep on the CPU, launches counted per colour
  visit, two sweeps bitwise equal.

The JAX package is imported inside the tests, so that the CUDA tests also
run on a GPU host without jax.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import kernels
from alfi_torch.mg import patches as tpatches
from alfi_torch.problems import ThreeDimLidDrivenCavityProblem as TorchLDC3
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          patch_composition="multiplicative", verbose=False)
PARAMS = {"nu": 0.05, "gamma": 1e4, "advect": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch_solver(problem, device="cpu"):
    return TorchSolver(problem, device=device, **KW)


@pytest.fixture(scope="module")
def pair():
    from alfi_tpu import ConstantPressureSolver as JaxSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

    torch.set_num_threads(1)
    return _torch_solver(TorchLDC(4)), JaxSolver(JaxLDC(4), **KW)


@pytest.mark.parametrize("dim", [2, 3])
def test_colours_equal_jax(dim):
    from alfi_tpu.mg import patches as jpatches
    from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem as JaxLDC3
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

    problem = TorchLDC(4) if dim == 2 else TorchLDC3(2)
    solver = TorchSolver(problem, device="cpu",
                         **dict(KW, patch_composition="additive"))
    direction = problem.relaxation_direction()
    jaxp = JaxLDC(4) if dim == 2 else JaxLDC3(2)
    assert jaxp.relaxation_direction() == direction
    for l, ps in enumerate(solver.vmg.patchsets, 1):
        mask = solver.vmg.levels[l].mask_flat.numpy()
        jps = jpatches.star_patches(solver.vmg.levels[l].V, mask)
        np.testing.assert_array_equal(ps.seed_points, jps.seed_points)
        np.testing.assert_array_equal(
            tpatches.direction_order(ps.seed_points, direction),
            jpatches.direction_order(jps.seed_points, direction))
        colors, ncolors = tpatches.color_patchset(ps, direction)
        jcolors, jncolors = jpatches.color_patchset(jps, direction)
        assert ncolors == jncolors
        np.testing.assert_array_equal(colors, jcolors)
        # the colour-ordered set: a permutation, colour by colour, and no
        # dof twice in a colour
        ordered, _, sweep = tpatches.build_multiplicative_solver(
            ps, direction=direction, device="cpu")
        order = np.argsort(colors, kind="stable")
        np.testing.assert_array_equal(ordered.dofs, ps.dofs[order])
        np.testing.assert_array_equal(ordered.l2p, ps.l2p[order])
        assert sweep.ncolors == ncolors
        assert sweep.seq == list(range(ncolors)) + list(
            range(ncolors))[::-1]
        for c, table in enumerate(sweep.tables):
            lo, hi = sweep.bounds[c], sweep.bounds[c + 1]
            assert (colors[order[lo:hi]] == c).all()
            assert int(torch.diff(table.offsets).max()) <= 1


def _cell_tensors(solver, l, seed):
    form = solver.vmg.levels[l].form
    rng = np.random.default_rng(seed)
    wind = torch.as_tensor(rng.standard_normal((form.V.ndof, form.dim)))
    return form.velocity_element_tensors(PARAMS, wind)


def test_sweep_equals_jax(pair):
    import jax.numpy as jnp

    ts, js = pair
    for l in range(1, ts.vmg.nlevels):
        T = _cell_tensors(ts, l, l)
        factor, sweep = ts.vmg.patch_solvers[l - 1]
        inv = factor(T)
        vals = ts.vmg.level_assemble(l, T)
        op = ts.vmg.level_ops[l]
        rng = np.random.default_rng(10 + l)
        b = rng.standard_normal(op.n) * ts.vmg.levels[l].mask_flat.numpy()
        x = sweep(inv, torch.as_tensor(b), lambda v: op(vals, v))

        jvmg = js.vmg
        Tj = jnp.asarray(T.numpy())
        jfactor, japply = jvmg.patch_solvers[l - 1]
        d = jvmg.d

        def Aop(xf):
            return jvmg.level_apply(l, Tj, xf.reshape(-1, d)).reshape(-1)

        xj = np.asarray(japply(jfactor(Tj), jnp.asarray(b), Aop))
        err = float(np.abs(x.numpy() - xj).max() / np.abs(xj).max())
        assert err < 1e-7, (l, err)


def test_almg_multiplicative_sweep(pair):
    """Re 100 from rest, the JAX test's case: converged with kpn <= 10,
    the JAX package's counts, the state within 1e-8."""
    ts, js = pair
    (zt, it), (zj, ij) = ts.solve(100), js.solve(100)
    assert it["converged"] and ij["converged"]
    assert it["linear_iter"] / max(1, it["nonlinear_iter"]) <= 10
    assert (it["linear_iter"], it["nonlinear_iter"]) == (
        int(ij["linear_iter"]), int(ij["nonlinear_iter"]))
    assert float(np.abs(zt[0].numpy() - np.asarray(zj[0])).max()) < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("dim,path", [(2, "pair"), (3, "strided")])
def test_cuda_colour_tables_match_plain(dim, path):
    """Each colour table on the card through the kernel its m takes, in a
    whole symmetrised sweep, against the same sweep on the CPU (the plain
    versions): relative error <= 1e-13, two sweeps bitwise equal, one
    launch per colour visit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    solver = _torch_solver(TorchLDC(4) if dim == 2 else TorchLDC3(2))
    _, cpu_sweep = solver.vmg.patch_solvers[-1]
    ps = cpu_sweep.patchset
    sweep = tpatches.MultiplicativeSweep(ps, cpu_sweep.bounds, device=dev)
    assert {t.kernel_path() for t in sweep.tables} == {
        {"pair": 1, "strided": 2}[path]}
    rng = np.random.default_rng(dim)
    inv = rng.standard_normal((ps.npatches, ps.m, ps.m))
    b = rng.standard_normal(ps.nflat)

    def aop(v):
        return 0.5 * v

    want = cpu_sweep(torch.as_tensor(inv), torch.as_tensor(b), aop)
    inv_d, b_d = torch.as_tensor(inv, device=dev), torch.as_tensor(
        b, device=dev)
    kernels.reset_launch_counts()
    x, x2 = sweep(inv_d, b_d, aop), sweep(inv_d, b_d, aop)
    torch.cuda.synchronize()
    assert kernels.GatherGemvScatter.launches["K1"] == 2 * len(sweep.seq)
    assert all(t.launched == 4 for t in sweep.tables)
    assert torch.equal(x, x2)
    err = float((x.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-13
