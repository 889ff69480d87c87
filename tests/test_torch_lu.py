"""The port's direct modes ``lu`` and ``allu`` against the JAX package,
f64 on the CPU, ldc2d [P2]^2-P0 baseN=4 nref=1 (the configuration of
tests/test_solver_lu.py and tests/test_almg.py::test_almg_matches_lu):

* the dense matrices: the BC-eliminated mixed Jacobian (``lu``, pressure
  pinned) and velocity block (``allu``) at one seeded state, equal to the
  JAX package's at 1e-12 (relative to the largest entry);
* the twins of tests/test_solver_lu.py's four tests: Stokes by ``lu``,
  the continuation Re 1, 10, 100 by ``lu`` (pressure pinned), ``allu``
  against ``lu`` (velocity within 1e-6), and the AL Schur counts of
  ``allu`` falling with gamma, each with the JAX package's counts and
  states within 1e-8;
* the twin of test_almg_matches_lu: ``almg`` within 1e-6 of ``lu``.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_torch.solvers import linear as tlinear
from alfi_torch.utils.tree import tnorm
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC
from alfi_tpu.solvers import linear as jlinear

KW = dict(nref=1, k=2, hierarchy="uniform", gamma=1e4, verbose=False)
STATE_TOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(solver_type, **kw):
    torch.set_num_threads(1)
    return (TorchSolver(TorchLDC(4), solver_type=solver_type, device="cpu",
                        **dict(KW, **kw)),
            JaxSolver(JaxLDC(4), solver_type=solver_type, **dict(KW, **kw)))


@pytest.fixture(scope="module")
def lu_pair():
    return _pair("lu")


def _close(a, b, tol):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()) < tol


def _same_solve(pair, re):
    """Solve Re in both packages; counts equal, states within 1e-8."""
    (zt, it), (zj, ij) = pair[0].solve(re), pair[1].solve(re)
    assert it["converged"] and ij["converged"]
    assert (it["linear_iter"], it["nonlinear_iter"]) == (
        int(ij["linear_iter"]), int(ij["nonlinear_iter"]))
    assert _close(zt[0].numpy(), zj[0], STATE_TOL)
    assert _close(zt[1].numpy(), zj[1], STATE_TOL)
    return zt, it


def _seeded_state(pair):
    """The same random (u, p) in both packages, BCs applied."""
    ts, js = pair
    rng = np.random.default_rng(0)
    u = rng.standard_normal((ts.Z.V.ndof, 2))
    p = rng.standard_normal(ts.Z.Q.ndof)
    zt = ts.bcset.apply((torch.as_tensor(u), torch.as_tensor(p)))
    zj = js.bcset.apply((np.asarray(u), np.asarray(p)))
    return zt, zj


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_dense_matrices_equal_jax(lu_pair):
    ts, js = lu_pair
    zt, zj = _seeded_state(lu_pair)
    pt = {"nu": 0.05, "gamma": 1e4, "advect": 1.0}
    pj = {k: np.float64(v) for k, v in pt.items()}
    A_t = tlinear.assemble_dense_mixed(ts.form, zt, pt, ts.bcset)
    A_j = jlinear.assemble_dense_mixed(js.form, zj, pj, js.bcset)
    assert A_t.shape == A_j.shape
    assert _rel(A_t.numpy(), A_j) < 1e-12
    # the pinned pressure dof is an identity row and column
    nV = ts.Z.V.ndof * 2
    assert float(A_t[nV, nV]) == 1.0
    assert float(A_t[nV].abs().sum()) == 1.0
    Av_t = tlinear.assemble_dense_velocity(ts.form, zt[0], pt,
                                           ts.bcset.mask[0])
    Av_j = jlinear.assemble_dense_velocity(js.form, zj[0], pj,
                                           js.bcset.mask[0])
    assert _rel(Av_t.numpy(), Av_j) < 1e-12
    # the in-place factor and solve against a dense solve
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(
        A_t.shape[0]))
    want = torch.linalg.solve(A_t, b)
    x = tlinear.lu_solve_closure(A_t.clone())(b)
    assert float((x - want).abs().max() / want.abs().max()) < 1e-10


def test_stokes_lu(lu_pair):
    s = lu_pair[0]
    z, info = _same_solve(lu_pair, 0)
    u, p = z
    F = s.residual_masked(z, s.params())
    assert float(tnorm(F)) < 1e-6
    assert float(u.abs().max()) > 0.1
    F0 = s.residual_masked(z, dict(s.params(), gamma=0.0))
    assert float(tnorm(F0)) < 1e-6
    assert float(torch.linalg.norm(s.form.apply_divergence(u))) < 1e-8


def test_navier_stokes_continuation_lu(lu_pair):
    s = lu_pair[0]
    assert not s.nsp  # the pinned pressure replaces the null space
    for re in [1, 10, 100]:
        z, info = _same_solve(lu_pair, re)
        assert info["nonlinear_iter"] <= 6
    u, p = z
    assert float(torch.linalg.norm(s.form.apply_divergence(u))) < 1e-8
    assert abs(float(p[0])) < 1e-12


def test_allu_fieldsplit_matches_lu():
    pair = _pair("allu")
    assert pair[0].nsp
    z_lu, _ = TorchSolver(TorchLDC(4), solver_type="lu", device="cpu",
                          **KW).solve(10)
    z_fs, info = _same_solve(pair, 10)
    assert float((z_lu[0] - z_fs[0]).abs().max()) < 1e-6
    dp = ((z_lu[1] - z_lu[1].mean()) - (z_fs[1] - z_fs[1].mean()))
    assert float(dp.abs().max()) < 1e-4


def test_al_schur_iterations_flat_in_gamma():
    """With the exact velocity-block inverse the outer FGMRES count
    falls as gamma grows (the mass-matrix Schur approximation becomes
    exact, arXiv:1810.03315); each gamma's Stokes solve takes the JAX
    package's count."""
    iters = {}
    for gamma in [1.0, 1e2, 1e4]:
        _, info = _same_solve(_pair("allu", gamma=gamma), 0)
        iters[gamma] = info["linear_iter"]
    assert iters[1e4] <= iters[1e2] <= iters[1.0]
    assert iters[1e4] <= 4


def test_almg_matches_lu():
    s_mg = TorchSolver(TorchLDC(4), solver_type="almg", device="cpu", **KW)
    s_lu = TorchSolver(TorchLDC(4), solver_type="lu", device="cpu", **KW)
    z1, i1 = s_mg.solve(10)
    z2, i2 = s_lu.solve(10)
    assert i1["converged"] and i2["converged"]
    assert float((z1[0] - z2[0]).abs().max()) < 1e-6
