"""The port's adjoint solve, visprolong and the refined VTU output against
the JAX package, f64 on the CPU, ldc2d [P2]^2-P0 baseN=4 nref=1 (the
configuration of tests/test_adjoint.py):

* the transposed masked Jacobian action (one torch.func.vjp) against
  jax.linear_transpose of the JAX package's masked jvp at a seeded state,
  with and without SUPG, at 1e-11;
* twins of tests/test_adjoint.py's two tests: ``lu``'s adjoint satisfies
  J^T lambda + dJ/dz = 0 (BC rows excluded, mean-projected) to 1e-6;
  ``allu``'s and ``almg``'s lambda lie within 1e-5 of ``lu``'s (pressure
  mean removed), almg's in fewer than 100 Krylov iterations, the JAX
  package's count, and within 1e-8 of its lambda; so does ``lsc``'s, under
  its own Schur PC (an AMG mode's adjoint, which the JAX package does not
  build);
* visprolong (nref_vis=1) against the JAX package's at 1e-12, and the
  driver's ``--nref-vis 1 --paraview`` file, whose text equals the JAX
  writer's on the same field.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import driver as tdriver
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_torch.solvers.linear import make_jacobian_rmatvec
from alfi_torch.utils.tree import tnorm
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC
from alfi_tpu.solvers.linear import make_jacobian_matvec as jax_matvec

KW = dict(nref=1, k=2, hierarchy="uniform", verbose=False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def kinetic_energy(z):
    return 0.5 * torch.sum(z[0] * z[0])


def jax_kinetic_energy(z):
    return 0.5 * jnp.sum(z[0] * z[0])


@pytest.mark.parametrize("stab", [None, "supg"])
def test_transposed_action_matches_jax(stab):
    ts = TorchSolver(TorchLDC(4), solver_type="almg", device="cpu",
                     stabilisation_type=stab, **KW)
    js = JaxSolver(JaxLDC(4), solver_type="almg", stabilisation_type=stab,
                   **KW)
    for s in (ts, js):
        s.nu_val, s.advect_val = 0.1, 1.0
    rng = np.random.default_rng(0)
    u = rng.standard_normal((ts.Z.V.ndof, 2))
    p = rng.standard_normal(ts.Z.Q.ndof)
    v = (rng.standard_normal((ts.Z.V.ndof, 2)),
         rng.standard_normal(ts.Z.Q.ndof))
    zt = ts.bcset.apply((torch.as_tensor(u), torch.as_tensor(p)))
    ts.z_last = zt
    zj = js.bcset.apply((jnp.asarray(u), jnp.asarray(p)))
    js.z_last = zj
    out_t = make_jacobian_rmatvec(ts.form.residual, ts.bcset, zt,
                                  ts.params())(
        tuple(torch.as_tensor(x) for x in v))
    fwd = jax_matvec(js.form.residual, js.bcset, zj, js.params())
    vj = tuple(jnp.asarray(x) for x in v)
    (out_j,) = jax.linear_transpose(fwd, vj)(vj)
    for a, b in zip(out_t, out_j):
        assert _rel(a.numpy(), b) <= 1e-11


def _solve_with(solver_type):
    s = TorchSolver(TorchLDC(4), solver_type=solver_type, device="cpu",
                    **KW)
    s.solve(1)
    s.solve(10)
    s.setup_adjoint(kinetic_energy)
    z_adj, info = s.solve_adjoint()
    return s, z_adj, info


@pytest.fixture(scope="module")
def lu_adjoint():
    torch.set_num_threads(1)
    return _solve_with("lu")


def test_adjoint_residual_lu(lu_adjoint):
    s, z_adj, _ = lu_adjoint
    # the adjoint equation: J^T z_adj + dJ/dz = 0 (BC rows excluded)
    JTlam = make_jacobian_rmatvec(s.form.residual, s.bcset, s.z,
                                  s.params())(z_adj)
    rhs = s.bcset.zero(torch.func.grad(kinetic_energy)(s.z))
    r = tuple(a + b for a, b in zip(s.bcset.zero(JTlam), rhs))
    if s.nsp:
        u, p = r
        r = (u, p - torch.mean(p))
    assert float(tnorm(r)) < 1e-6 * max(1.0, float(tnorm(rhs)))


@pytest.mark.parametrize("mode", ["allu", "almg", "lsc"])
def test_adjoint_matches_lu(lu_adjoint, mode):
    _, adj_lu, _ = lu_adjoint
    _, adj, info = _solve_with(mode)
    u1, p1 = adj_lu
    u2, p2 = adj
    assert float((u1 - u2).abs().max()) < 1e-5 * (
        1.0 + float(u1.abs().max()))
    # pressure gauge differs (lu pins, the others mean-normalise):
    # compare mean-removed
    p1 = p1 - torch.mean(p1)
    p2 = p2 - torch.mean(p2)
    assert float((p1 - p2).abs().max()) < 1e-5 * (
        1.0 + float(p1.abs().max()))
    assert info["linear_iter"] < 100
    if mode == "almg":
        js = JaxSolver(JaxLDC(4), solver_type="almg", **KW)
        js.solve(1)
        js.solve(10)
        js.setup_adjoint(jax_kinetic_energy)
        adj_j, info_j = js.solve_adjoint()
        assert info["linear_iter"] == int(info_j["linear_iter"])
        for a, b in zip(adj, adj_j):
            assert _rel(a.numpy(), b) <= 1e-8


@pytest.fixture(scope="module")
def vis_pair():
    torch.set_num_threads(1)
    return (TorchSolver(TorchLDC(4), solver_type="lu", nref_vis=1,
                        device="cpu", **KW),
            JaxSolver(JaxLDC(4), solver_type="lu", nref_vis=1, **KW))


def test_visprolong_matches_jax(vis_pair):
    ts, js = vis_pair
    u = np.random.default_rng(1).standard_normal((ts.Z.V.ndof, 2))
    ut, mt, Vt = ts.visprolong(torch.as_tensor(u))
    uj, mj, Vj = js.visprolong(jnp.asarray(u))
    assert (mt.num_vertices, mt.num_cells) == (mj.num_vertices, mj.num_cells)
    assert Vt.ndof == Vj.ndof == ut.shape[0]
    assert _rel(ut.numpy(), uj) <= 1e-12


def test_paraview_writes_the_refined_velocity(vis_pair, tmp_path):
    """``--nref-vis 1 --paraview`` through the driver writes the prolonged
    velocity on the refined mesh, in the JAX writer's text."""
    from alfi_tpu.utils.vtk import write_velocity_vtu as jax_write

    ts, _ = vis_pair
    args = tdriver.get_default_parser().parse_args(
        ["--discretisation", "pkp0", "--nref-vis", "1", "--paraview"])
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        tdriver.run_solver(ts, [1], args)
    finally:
        os.chdir(cwd)
    path = tmp_path / "output" / str(ts.Z.dim) / "velocity-refined-Re-1.vtu"
    text = path.read_text()
    u, mesh, _ = ts.visprolong(ts.z[0])
    assert ('NumberOfPoints="%d" NumberOfCells="%d"'
            % (mesh.num_vertices, mesh.num_cells)) in text
    ref = tmp_path / "jax.vtu"
    jax_write(str(ref), mesh, u.numpy())
    assert text == ref.read_text()
