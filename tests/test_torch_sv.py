"""The port's Scott-Vogelius discretisation against the JAX package, f64
on the CPU, same inputs from a numpy seed through both: ldc2d SV k=2
([P2]^2-DG1, exact grad-div) on the barycentric hierarchy with macrostar
patches, baseN=3 nref=1 (the configuration of
tests/test_almg.py::test_almg_sv_bary_macro), and the 3D bary tables of
SV k=3 at baseN=1.

* exact grad-div: the residual, the element tensors and
  ``graddiv_factors`` (1e-12); the pressure blocks with a DG1 pressure;
* the host tables on bary: macrostar patches (2D and 3D), the
  non-nested point-evaluation transfers and the Schoeberl cell groups,
  entry by entry; the transfers' applies (1e-12) and Schoeberl's
  (1e-7: gamma=1e4 patch operators through explicit inverses in the
  port, LU solves in the JAX CPU path);
* ``ErrorComputer.divergence_norm`` (1e-12);
* the twin of test_almg_sv_bary_macro through both drivers: converged
  at Re 10 with the JAX counts, state within 1e-8, divergence < 1e-8;
  and the SV checkpoints (DG1 pressure) load in the other package.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ScottVogeliusSolver as TorchSV
from alfi_torch import driver as tdriver
from alfi_torch import fem as tfem
from alfi_torch.fem.errors import ErrorComputer as TorchErrors
from alfi_torch.mg.patches import macrostar_patches as torch_macrostar
from alfi_torch.mg.schoeberl import SchoeberlTransfer as TorchSchoeberl
from alfi_torch.problems import ThreeDimLidDrivenCavityProblem as TorchLDC3
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_tpu import ScottVogeliusSolver as JaxSV
from alfi_tpu import driver as jdriver
from alfi_tpu import fem as jfem
from alfi_tpu.fem.errors import ErrorComputer as JaxErrors
from alfi_tpu.mg.patches import macrostar_patches as jax_macrostar
from alfi_tpu.mg.schoeberl import SchoeberlTransfer as JaxSchoeberl
from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem as JaxLDC3
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="bary", patch="macro",
          gamma=1e4, verbose=False)
PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}
ARGV = ["--discretisation", "sv", "--mh", "bary", "--patch", "macro",
        "--baseN", "3", "--nref", "1", "--k", "2", "--checkpoint"]
RES = [10]
COUNTS = ("linear_iter", "nonlinear_iter")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solvers():
    torch.set_num_threads(1)
    return (TorchSV(TorchLDC(3), device="cpu", **KW), JaxSV(JaxLDC(3), **KW))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _state(t, seed):
    rng = np.random.default_rng(seed)
    mask, vals = t.bcset.mask[0].numpy(), t.bcset.values[0].numpy()
    u = mask * 0.5 * rng.standard_normal((t.Z.V.ndof, 2)) + vals
    return u, rng.standard_normal(t.Z.Q.ndof)


def test_sv_spaces_match_jax(solvers):
    t, j = solvers
    assert t.form.graddiv_mode == j.form.graddiv_mode == "exact"
    assert t.Z.Q.element.degree == 1 and t.Z.Q.element.nloc == 3
    assert np.array_equal(t.Z.V.cell_dofs, np.asarray(j.Z.V.cell_dofs))
    assert np.array_equal(t.Z.Q.cell_dofs, np.asarray(j.Z.Q.cell_dofs))
    assert t.Z.dim == j.Z.dim


def test_exact_graddiv_residual_matches_jax(solvers):
    t, j = solvers
    u, p = _state(t, 0)
    for gamma in (0.0, 1e4):
        params = dict(PARAMS, gamma=gamma)
        Rt = t.form.residual((torch.as_tensor(u), torch.as_tensor(p)),
                             params)
        Rj = j.form.residual((jnp.asarray(u), jnp.asarray(p)),
                             {k: jnp.asarray(v) for k, v in params.items()})
        assert _rel(Rt[0], Rj[0]) < 1e-12
        assert _rel(Rt[1], Rj[1]) < 1e-12


def test_exact_graddiv_factors_match_jax(solvers):
    t, j = solvers
    Bt, Bj = t.form.graddiv_factors(), j.form.graddiv_factors()
    assert Bt.shape[-1] == Bj.shape[-1] == 4  # collapsed 2 x 2 rule
    assert _rel(Bt, Bj) < 1e-12


def test_exact_graddiv_element_tensors_match_jax(solvers):
    t, j = solvers
    wind, _ = _state(t, 1)
    (Kt, Gt), (Kj, Gj) = (t.form._static_velocity_tensors(),
                          j.form._static_velocity_tensors())
    assert _rel(Kt, Kj) < 1e-12 and _rel(Gt, Gj) < 1e-12
    Tt = t.form.velocity_element_tensors(PARAMS, torch.as_tensor(wind))
    Tj = j.form.velocity_element_tensors(
        {k: jnp.asarray(v) for k, v in PARAMS.items()}, jnp.asarray(wind))
    assert _rel(Tt, Tj) < 1e-12


def test_exact_graddiv_tensors_are_the_residual_jacobian(solvers):
    """G is the Jacobian of the exact grad-div term: gamma G u equals the
    residual's gamma part (nu = advect = 0, p = 0) cell by cell."""
    t, _ = solvers
    u, _ = _state(t, 2)
    u_loc = torch.as_tensor(u)[t.form.cd_v]
    nc, nl = u_loc.shape[:2]
    rv = t.form.cell_velocity_residual(
        u_loc, u_loc, {"nu": 0.0, "gamma": 1.0, "advect": 0.0})
    _, G = t.form._static_velocity_tensors()
    Gu = torch.einsum("cij,cj->ci", G, u_loc.reshape(nc, -1))
    assert _rel(Gu, rv.reshape(nc, -1)) < 1e-12


@pytest.mark.parametrize("op", ["gradient", "divergence", "integral",
                                "massinv"])
def test_pressure_blocks_with_dg1_match_jax(solvers, op):
    t, j = solvers
    u, p = _state(t, 3)
    if op == "gradient":
        out = (t.form.apply_pressure_gradient(torch.as_tensor(p)),
               j.form.apply_pressure_gradient(jnp.asarray(p)))
    elif op == "divergence":
        out = (t.form.apply_divergence(torch.as_tensor(u)),
               j.form.apply_divergence(jnp.asarray(u)))
    elif op == "integral":
        out = (t.form.pressure_integral(torch.as_tensor(p)),
               j.form.pressure_integral(jnp.asarray(p)))
    else:
        mt, mj = (t.form.pressure_mass_inverse(),
                  j.form.pressure_mass_inverse())
        assert _rel(mt, mj) < 1e-12
        out = (t.form.apply_pressure_massinv(mt, torch.as_tensor(p)),
               j.form.apply_pressure_massinv(mj, jnp.asarray(p)))
    assert _rel(*out) < 1e-12


def _sv_spaces_3d(fem, problem):
    mh = problem.mesh_hierarchy("bary", 1)
    return mh, [fem.VectorFunctionSpace(m, fem.lagrange(3, 3)) for m in mh]


@pytest.fixture(scope="module")
def bary3d():
    """(torch, JAX) bary hierarchies and SV k=3 velocity spaces of ldc3d
    baseN=1 nref=1, and a seeded 0/1 mask."""
    tmh, tV = _sv_spaces_3d(tfem, TorchLDC3(1))
    jmh, jV = _sv_spaces_3d(jfem, JaxLDC3(1))
    rng = np.random.default_rng(4)
    mask = (rng.random(tV[1].ndof * 3) < 0.9).astype(float)
    return tmh, tV, jmh, jV, mask


def _same_patchset(a, b):
    assert (a.m, a.npatches, a.nflat) == (b.m, b.npatches, b.nflat)
    for key in ("dofs", "cells", "l2p", "active", "sizes"):
        assert np.array_equal(getattr(a, key), np.asarray(getattr(b, key))), \
            key


def test_macrostar_patches_match_jax_2d(solvers):
    t, j = solvers
    pt, pj = t.vmg.patchsets[0], j.vmg.patchsets[0]
    assert pt.m == 62
    _same_patchset(pt, pj)
    assert np.array_equal(pt.seed_points, np.asarray(pj.seed_points))


def test_macrostar_patches_match_jax_3d(bary3d):
    _, tV, _, jV, mask = bary3d
    pt, pj = torch_macrostar(tV[1], mask), jax_macrostar(jV[1], mask)
    assert pt.m > 500  # macrostar patches of [P3]^3 are large
    _same_patchset(pt, pj)


@pytest.mark.parametrize("op", ["prolong", "restrict", "inject"])
def test_bary_transfers_match_jax(solvers, op):
    """The non-nested point-evaluation transfers of the bary hierarchy:
    tables entry by entry, applies to 1e-12."""
    t, j = solvers
    tt = t.vmg.injects[0] if op == "inject" else t.vmg.prolongs[0]
    jt = j.vmg.injects[0] if op == "inject" else j.vmg.prolongs[0]
    assert np.array_equal(tt.idx.numpy(), np.asarray(jt.idx))
    assert _rel(tt.w, jt.w) < 1e-14
    rng = np.random.default_rng(5)
    nsrc = tt.source.ndof if op != "restrict" else tt.target.ndof
    x = rng.standard_normal((nsrc, 2))
    if op == "restrict":
        out = (tt.apply_transpose(torch.as_tensor(x)),
               jt.apply_transpose(jnp.asarray(x)))
    else:
        out = tt.apply(torch.as_tensor(x)), jt.apply(jnp.asarray(x))
    assert _rel(*out) < 1e-12


def test_bary_schoeberl_tables_match_jax(solvers):
    t, j = solvers
    ts, js = t.vmg.schoeberl[0], j.vmg.schoeberl[0]
    assert np.array_equal(ts.zmask.numpy(), np.asarray(js.zmask))
    _same_patchset(ts.patchset, js.patchset)
    n, groups = TorchSchoeberl._patch_cell_groups(t.mh, 0)
    nj, groups_j = JaxSchoeberl._patch_cell_groups(j.mh, 0)
    assert n == nj == 12  # 4 uniform children x 3 bary cells
    assert np.array_equal(groups, np.asarray(groups_j))


def test_bary_schoeberl_groups_match_jax_3d(bary3d):
    tmh, _, jmh, _, _ = bary3d
    n, groups = TorchSchoeberl._patch_cell_groups(tmh, 0)
    nj, groups_j = JaxSchoeberl._patch_cell_groups(jmh, 0)
    assert n == nj == 32  # 8 uniform children x 4 bary cells
    assert np.array_equal(groups, np.asarray(groups_j))


@pytest.mark.parametrize("op", ["prolong", "restrict"])
def test_bary_schoeberl_matches_jax(solvers, op):
    t, j = solvers
    ts, js = t.vmg.schoeberl[0], j.vmg.schoeberl[0]
    st_t = ts.setup(PARAMS, t._almg_static["schoeberl"][0])
    st_j = js.setup({k: jnp.asarray(v) for k, v in PARAMS.items()},
                    static=j._almg_static["schoeberl"][0])
    rng = np.random.default_rng(6)
    if op == "prolong":
        x = rng.standard_normal((t.vmg.levels[0].V.ndof, 2))
        out = (ts.prolong(st_t, torch.as_tensor(x)),
               js.prolong(st_j, jnp.asarray(x)))
    else:
        x = rng.standard_normal((t.vmg.levels[1].V.ndof, 2))
        out = (ts.restrict(st_t, torch.as_tensor(x)),
               js.restrict(st_j, jnp.asarray(x)))
    assert _rel(*out) < 1e-7


def test_divergence_norm_matches_jax(solvers):
    t, j = solvers
    u, _ = _state(t, 7)
    a = float(TorchErrors(t.form).divergence_norm(torch.as_tensor(u)))
    b = float(JaxErrors(j.form).divergence_norm(jnp.asarray(u)))
    assert a > 0 and abs(a - b) <= 1e-12 * b


def _in_dir(path, fn):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _run(pkg, problem, path, forbid_solve=False, **kw):
    args = pkg.get_default_parser().parse_args(ARGV)
    solver = pkg.get_solver(args, problem, **kw)
    solver.verbose = False
    if forbid_solve:
        def no_solve(re):
            raise AssertionError("solved Re=%s instead of loading it" % re)
        solver.solve = no_solve
    return solver, _in_dir(path, lambda: pkg.run_solver(solver, RES, args))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The twin of test_almg_sv_bary_macro through each package's driver,
    each writing its checkpoints into a directory of its own."""
    torch.set_num_threads(1)
    tdir = tmp_path_factory.mktemp("port")
    jdir = tmp_path_factory.mktemp("jax")
    tsolver, tres = _run(tdriver, TorchLDC(3), tdir, device="cpu")
    jsolver, jres = _run(jdriver, JaxLDC(3), jdir)
    return tdir, tsolver, tres, jdir, jsolver, jres


def test_sv_solve_takes_the_jax_counts(sweeps):
    """Converged at Re 10 with the JAX package's counts; the state within
    1e-8; the velocity pointwise divergence-free to 1e-8."""
    _, tsolver, tres, _, jsolver, jres = sweeps
    assert tres[10]["converged"] and jres[10]["converged"]
    counts = [tuple(int(r[10][k]) for k in COUNTS) for r in (tres, jres)]
    assert counts[0] == counts[1]
    for a, b in zip(tsolver.z, jsolver.z):
        assert _rel(a, b) < 1e-8
    assert float(TorchErrors(tsolver.form).divergence_norm(
        tsolver.z[0])) < 1e-8


def test_port_loads_jax_sv_checkpoint(sweeps):
    _, _, _, jdir, jsolver, jres = sweeps
    solver, res2 = _run(tdriver, TorchLDC(3), jdir, forbid_solve=True,
                        device="cpu")
    assert res2[10]["checkpointed"]
    assert all(res2[10][k] == jres[10][k] for k in COUNTS)
    assert solver.z[1].shape == (solver.Z.Q.ndof,)
    for a, b in zip(solver.z, jsolver.z):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_jax_loads_port_sv_checkpoint(sweeps):
    tdir, tsolver, tres, _, _, _ = sweeps
    solver, res2 = _run(jdriver, JaxLDC(3), tdir, forbid_solve=True)
    assert res2[10]["checkpointed"]
    assert all(res2[10][k] == tres[10][k] for k in COUNTS)
    for a, b in zip(solver.z, tsolver.z):
        assert np.array_equal(np.asarray(a), b.numpy())
