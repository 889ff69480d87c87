"""The port's manufactured-solution path against the JAX package, f64 on
the CPU, same inputs from a numpy seed through both: the Shih-Tan-Hwang
cavity (``problems/mms.py``) in 2D and 3D.

* the forcing ``rhs()`` at the form's quadrature points (1e-12);
* the residual with the forcing (1e-12);
* the SUPG residual (whole, and in cell chunks: 1e-14) and its analytic
  velocity-block Jacobian with the forcing (1e-11): the SUPG test
  function depends on the state, so the forcing enters the Jacobian;
* ``ErrorComputer.velocity_errors`` and ``pressure_error`` on the same
  state (1e-12 relative);
* the twin of tests/test_problems3d.py::test_mms3d_errors_converge (lu,
  baseN 2 then 4; the errors at baseN 2 equal the JAX package's);
* one 2D convergence-order check by ``lu`` at baseN 2 and 4.
"""

import jax
import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch.fem.errors import ErrorComputer as TorchErrors
from alfi_torch.problems import ThreeDimLidDrivenCavityMMSProblem as TorchMMS3
from alfi_torch.problems import TwoDimLidDrivenCavityMMSProblem as TorchMMS
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.fem.errors import ErrorComputer as JaxErrors
from alfi_tpu.problems import ThreeDimLidDrivenCavityMMSProblem as JaxMMS3
from alfi_tpu.problems import TwoDimLidDrivenCavityMMSProblem as JaxMMS

KW = dict(nref=0, k=2, solver_type="lu", hierarchy="uniform", gamma=1e4,
          verbose=False)
PARAMS = {"nu": 0.05, "gamma": 1e4, "advect": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def supg_pair():
    """The 2D MMS problem at baseN=4 with SUPG in both packages."""
    torch.set_num_threads(1)
    kw = dict(KW, stabilisation_type="supg")
    return (TorchSolver(TorchMMS(4), device="cpu", **kw),
            JaxSolver(JaxMMS(4), **kw))


def _seeded(pair, seed=0):
    ts, js = pair
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((ts.Z.V.ndof, ts.tdim))
    p = rng.standard_normal(ts.Z.Q.ndof)
    return ((torch.as_tensor(u), torch.as_tensor(p)),
            (np.asarray(u), np.asarray(p)))


def _jparams():
    return {k: np.float64(v) for k, v in PARAMS.items()}


def test_forcing_at_the_quadrature_points(supg_pair):
    ts, js = supg_pair
    xq = js.form.geom.quad_points_physical(js.form.tab_v.ref_pts)
    assert _rel(ts.form.xq.numpy(), xq) < 1e-15
    nc, nq, d = ts.form.xq.shape
    f_t, fq_t = ts.problem.rhs()(ts.form.xq.reshape(-1, d), PARAMS)
    f_j, fq_j = jax.jit(js.problem.rhs())(np.asarray(xq).reshape(-1, d),
                                          _jparams())
    assert _rel(f_t.numpy(), f_j) < 1e-12
    assert float(fq_t.abs().max()) == 0.0 == float(np.abs(fq_j).max())
    # the form's own evaluation, and the kept copy for the same params
    fv, _ = ts.form.forcing(PARAMS)
    assert torch.equal(fv.reshape(-1, d), f_t)
    assert ts.form.forcing(dict(PARAMS))[0] is fv
    assert ts.form.forcing(dict(PARAMS, nu=0.1))[0] is not fv


def test_residual_with_forcing(supg_pair):
    ts, js = supg_pair
    zt, zj = _seeded(supg_pair)
    rt = ts.form.residual(zt, PARAMS)
    rj = jax.jit(js.form.residual)(zj, _jparams())
    assert _rel(rt[0].numpy(), rj[0]) < 1e-12
    assert _rel(rt[1].numpy(), rj[1]) < 1e-12


def test_supg_residual_and_jacobian_with_forcing(supg_pair):
    ts, js = supg_pair
    zt, zj = _seeded(supg_pair, 1)
    # the stabilisation alone, not advect-scaled
    st, sj = ts.stabilisation.impl, js.stabilisation.impl
    Rt = st.residual(zt, PARAMS)
    Rj = jax.jit(sj.residual)(zj, _jparams())
    assert _rel(Rt[0].numpy(), Rj[0]) < 1e-11
    # in cell chunks (a short tail chunk too) it is the same sum
    nc = ts.form.geom.detj.shape[0]
    assert nc > 12 and nc % 12
    st.residual_chunk = lambda: 12
    try:
        Rc = st.residual(zt, PARAMS)
    finally:
        del st.residual_chunk
    assert _rel(Rc[0].numpy(), Rt[0].numpy()) < 1e-14
    Jt = st.velocity_element_tensors(zt, PARAMS)
    Jj = jax.jit(sj.velocity_element_tensors)(zj, _jparams())
    assert _rel(Jt.numpy(), Jj) < 1e-11
    # the forcing moves the Jacobian (it would not without SUPG)
    form = ts.form
    rhs, form.rhs = form.rhs, None
    try:
        J0 = st.velocity_element_tensors(zt, PARAMS)
    finally:
        form.rhs = rhs
    assert _rel(J0.numpy(), Jt.numpy()) > 1e-6


def test_error_computer_on_the_same_state(supg_pair):
    ts, js = supg_pair
    zt, zj = _seeded(supg_pair, 2)
    et, ej = TorchErrors(ts.form), JaxErrors(js.form)
    nu = PARAMS["nu"]
    for a, b in zip(et.velocity_errors(zt[0], ts.problem.u_exact),
                    ej.velocity_errors(zj[0], js.problem.u_exact)):
        assert abs(float(a) / float(b) - 1.0) < 1e-12
    a = et.pressure_error(zt[1], lambda x: ts.problem.p_exact(x, nu))
    b = ej.pressure_error(zj[1], lambda x: js.problem.p_exact(x, nu))
    assert abs(float(a) / float(b) - 1.0) < 1e-12
    a, b = et.divergence_norm(zt[0]), ej.divergence_norm(zj[0])
    assert abs(float(a) / float(b) - 1.0) < 1e-12


def _errors(solver_t, problem, re=10):
    s = solver_t(problem)
    z, info = s.solve(re)
    assert info["converged"]
    nu = s.nu_val
    ec = (TorchErrors if isinstance(s, TorchSolver) else JaxErrors)(s.form)
    ul2, uh1 = ec.velocity_errors(z[0], problem.u_exact)
    pl2 = ec.pressure_error(z[1], lambda x: problem.p_exact(x, nu))
    return np.array([float(ul2), float(uh1), float(pl2)])


def _torch(problem):
    return TorchSolver(problem, device="cpu", **KW)


def _jax(problem):
    return JaxSolver(problem, **KW)


def test_mms3d_errors_converge():
    errs = [_errors(_torch, TorchMMS3(n)) for n in [2, 4]]
    assert errs[1][0] < 0.5 * errs[0][0]
    assert errs[1][1] < 0.7 * errs[0][1]
    assert np.abs(errs[0] / _errors(_jax, JaxMMS3(2)) - 1.0).max() < 1e-8


def test_mms2d_pkp0_orders_by_lu():
    """[P2]^2-P0 at Re 10: u L2 at about second order, u H1 and p L2 at
    about first order, from baseN 2 to 4; the errors at baseN 2 equal the
    JAX package's."""
    errs = [_errors(_torch, TorchMMS(n)) for n in [2, 4]]
    orders = np.log2(errs[0] / errs[1])
    assert orders[0] > 1.5 and orders[1] > 0.8 and orders[2] > 0.8
    assert np.abs(errs[0] / _errors(_jax, JaxMMS(2)) - 1.0).max() < 1e-8
