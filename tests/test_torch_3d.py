"""The port's 3D path against the JAX package, f64 on the CPU, same
inputs from a numpy seed through both: ldc3d baseN=2 nref=1 with
[P2+FB]^3-P0 (k=2, 5,163 dofs: star patches m = 189, Schoeberl patches
m = 27, level rows nld = 42) and [P1+FB]^3-P0 (k=1, 3,351 dofs: m = 138,
24, nld = 24, and the flux-corrected BubbleTransfer), and the 3D
backwards-facing step (no pressure null space).

Tolerances: 1e-12 where only the summation order differs (transfers, the
level matvec); 1e-7 where the gamma=1e4 patch operators (condition
numbers up to ~1e8) go through explicit inverses in the port and LU
solves in the JAX CPU path (patch applies, the FMG cycle); 1e-8 for
converged states and one Newton update.

One torch thread throughout: with several, the batched inverse at m = 189
does not return on some hosts (an MKL DLASWP parameter error).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import driver as tdriver
from alfi_torch.mesh import box_mesh as torch_box_mesh
from alfi_torch.mesh import mesh_hierarchy as torch_mesh_hierarchy
from alfi_torch.mg.bubble import BubbleTransfer as TorchBubble
from alfi_torch.mg.transfer import PointEvalTransfer
from alfi_torch.problems import (
    ThreeDimBackwardsFacingStepProblem as TorchBFS3,
)
from alfi_torch.problems import ThreeDimLidDrivenCavityProblem as TorchLDC3
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu import driver as jdriver
from alfi_tpu.mesh import box_mesh as jax_box_mesh
from alfi_tpu.mesh import mesh_hierarchy as jax_mesh_hierarchy
from alfi_tpu.mg.bubble import BubbleTransfer as JaxBubble
from alfi_tpu.problems import ThreeDimBackwardsFacingStepProblem as JaxBFS3
from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem as JaxLDC3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(nref=1, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}
RES = [1, 10]
ARGV = ["--discretisation", "pkp0", "--mh", "uniform", "--baseN", "2",
        "--nref", "1", "--k", "2", "--checkpoint"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _in_dir(path, fn):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _sweep(t, j):
    rec = {}
    for re in RES:
        zt, it = t.solve(re)
        zj, ij = j.solve(re)
        rec[re] = ([x.numpy().copy() for x in zt], it,
                   [np.asarray(x) for x in zj], ij)
    return rec


def _counts(info):
    return (int(info["linear_iter"]), int(info["nonlinear_iter"]))


@pytest.fixture(scope="module")
def cav2(tmp_path_factory):
    """[P2+FB]^3: both packages through their drivers with --checkpoint,
    each into a directory of its own."""
    torch.set_num_threads(1)
    tdir = tmp_path_factory.mktemp("port3d")
    jdir = tmp_path_factory.mktemp("jax3d")
    targs = tdriver.get_default_parser().parse_args(ARGV)
    jargs = jdriver.get_default_parser().parse_args(ARGV)
    t = tdriver.get_solver(targs, TorchLDC3(2), device="cpu")
    j = jdriver.get_solver(jargs, JaxLDC3(2))
    t.verbose = j.verbose = False
    tres = _in_dir(tdir, lambda: tdriver.run_solver(t, RES, targs))
    zt = [x.numpy().copy() for x in t.z]
    jres = _in_dir(jdir, lambda: jdriver.run_solver(j, RES, jargs))
    zj = [np.asarray(x) for x in j.z]
    return dict(t=t, j=j, tdir=tdir, jdir=jdir, tres=tres, jres=jres,
                targs=targs, jargs=jargs, zt=zt, zj=zj)


@pytest.fixture(scope="module")
def cav1():
    """[P1+FB]^3, solved directly."""
    torch.set_num_threads(1)
    t = TorchSolver(TorchLDC3(2), k=1, device="cpu", **KW)
    j = JaxSolver(JaxLDC3(2), k=1, **KW)
    return t, j, _sweep(t, j)


@pytest.fixture(scope="module")
def supg2():
    torch.set_num_threads(1)
    kw = dict(KW, k=2, stabilisation_type="supg", restriction=True)
    t = TorchSolver(TorchLDC3(2), device="cpu", **kw)
    j = JaxSolver(JaxLDC3(2), **kw)
    return t, j, _sweep(t, j)


# ----------------------------------------------------------------------
# (a) the flux-corrected transfer
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bubbles():
    mt = torch_mesh_hierarchy(torch_box_mesh(2, 2, 2, 2, 2, 2), "uniform", 1)
    mj = jax_mesh_hierarchy(jax_box_mesh(2, 2, 2, 2, 2, 2), "uniform", 1)
    return TorchBubble(mt, 0, device="cpu"), JaxBubble(mj, 0), mt


def _bubble_sizes(mh):
    return (mh[0].num_vertices + mh[0].facet_vertices.shape[0],
            mh[1].num_vertices + mh[1].facet_vertices.shape[0])


@pytest.mark.parametrize("op", ["apply", "apply_transpose"])
def test_bubble_transfer_matches_jax(bubbles, op):
    tb, jb, mh = bubbles
    nc, nf = _bubble_sizes(mh)
    x = _rand((nc if op == "apply" else nf, 3), 21)
    out_t = getattr(tb, op)(torch.as_tensor(x))
    out_j = getattr(jb, op)(jnp.asarray(x))
    assert out_t.shape == ((nf if op == "apply" else nc), 3)
    assert _rel(out_t, out_j) < 1e-12


def test_bubble_transpose_is_the_adjoint(bubbles):
    tb, _, mh = bubbles
    nc, nf = _bubble_sizes(mh)
    u = torch.as_tensor(_rand((nc, 3), 22))
    r = torch.as_tensor(_rand((nf, 3), 23))
    Pu_r = float((tb.apply(u) * r).sum())
    u_Ptr = float((u * tb.apply_transpose(r)).sum())
    assert abs(Pu_r - u_Ptr) <= 1e-12 * max(abs(Pu_r), 1.0)


def test_bubble_scales_the_normal_flux(bubbles):
    """A coarse field that is one facet bubble along its facet's normal
    comes out of _scale 1/0.625 times as large; a tangential one is
    unchanged."""
    tb = bubbles[0]
    n = tb.nc_[5]
    fb = torch.zeros_like(tb.nc_)
    fb[5] = n
    assert torch.allclose(tb._scale(fb)[5], n / 0.625, rtol=1e-14)
    tang = torch.linalg.cross(n, torch.roll(n, 1))
    fb[5] = tang
    assert torch.allclose(tb._scale(fb)[5], tang, rtol=0, atol=1e-14)


def test_p1fb_in_3d_uses_the_bubble_transfer(cav1, cav2):
    """[P1+FB]^3 takes BubbleTransfer as its standard transfer, also
    inside the Schoeberl transfer; [P2+FB]^3 keeps point evaluation."""
    t1, t2 = cav1[0], cav2["t"]
    assert t1.Z.V.element.name == "P1FB"
    assert all(isinstance(p, TorchBubble) for p in t1.vmg.prolongs)
    assert t1.vmg.schoeberl[0].standard is t1.vmg.prolongs[0]
    assert all(isinstance(p, PointEvalTransfer) for p in t2.vmg.prolongs)
    # and it is the JAX package's operator
    x = _rand((t1.vmg.levels[0].V.ndof, 3), 24)
    assert _rel(t1.vmg.prolongs[0].apply(torch.as_tensor(x)),
                cav1[1].vmg.prolongs[0].apply(jnp.asarray(x))) < 1e-12


# ----------------------------------------------------------------------
# (b) the 3D tables through the plain version of the fused operation
# ----------------------------------------------------------------------
def test_3d_table_shapes(cav1, cav2):
    t1, t2 = cav1[0], cav2["t"]
    shapes = [(s.vmg.patch_solvers[0][1].ashape,
               s.vmg.schoeberl[0].papply.ashape,
               s.vmg.levels[1].matvec.ashape) for s in (t2, t1)]
    assert shapes == [((125, 189, 189), (48, 27, 27), (384, 42, 42)),
                      ((125, 138, 138), (48, 24, 24), (384, 24, 24))]


def test_3d_level_matvec_matches_jax(cav2):
    t, j = cav2["t"], cav2["j"]
    lev = t.vmg.levels[1]
    nc, nld = lev.rows.shape
    assert nld == 42
    T = _rand((nc, nld, nld), 31)
    v = _rand((lev.V.ndof, 3), 32)
    v0 = torch.as_tensor(v).reshape(-1)
    out_t = lev.matvec.plain(torch.as_tensor(T), v0, v0)
    out_j = j.vmg.level_apply(1, jnp.asarray(T), jnp.asarray(v))
    assert _rel(out_t.reshape(-1, 3), out_j) < 1e-12
    assert torch.equal(out_t.reshape(-1, 3),
                       t.vmg.level_apply(1, torch.as_tensor(T),
                                         torch.as_tensor(v)))


@pytest.mark.parametrize("kind", ["smoother", "schoeberl"])
def test_3d_patch_apply_matches_jax(cav2, kind):
    """m = 189 (star) and m = 27 (Schoeberl): explicit inverses through
    GatherGemvScatter.plain against the JAX patch solver's apply with
    the masks its callers put around it."""
    t, j = cav2["t"], cav2["j"]
    w = _rand((t.Z.V.ndof, 3), 33)
    tform, jform = t.vmg.levels[1].form, j.vmg.levels[1].form
    r = _rand((t.Z.V.ndof * 3,), 34)
    rt = torch.as_tensor(r)
    if kind == "smoother":
        (tfac, tapply), (jfac, japply) = (t.vmg.patch_solvers[0],
                                          j.vmg.patch_solvers[0])
        assert tapply.m == 189
        Tt = tform.velocity_element_tensors(PARAMS, torch.as_tensor(w))
        Tj = jform.velocity_element_tensors(PARAMS, jnp.asarray(w))
        mask = np.asarray(j.vmg.levels[1].mask_flat)
        out_t = tapply.plain(tfac(Tt), rt, rt)
        out_j = (mask * np.asarray(japply(jfac(Tj), jnp.asarray(mask * r)))
                 + (1.0 - mask) * r)
    else:
        ts, js = t.vmg.schoeberl[0], j.vmg.schoeberl[0]
        assert ts.papply.m == 27
        p0 = dict(PARAMS, advect=0.0)
        Tt = tform.velocity_element_tensors(p0, torch.as_tensor(w))
        Tj = jform.velocity_element_tensors(p0, jnp.asarray(w))
        zmask = np.asarray(js.zmask).reshape(-1)
        out_t = ts.papply.plain(ts.factor(Tt), rt)
        out_j = js.papply(js.factor(Tj), jnp.asarray(zmask * r))
    assert _rel(out_t, out_j) < 1e-7


def test_patch_contraction_index_is_built_once(cav2):
    """contract_patch_tensors keeps its scatter index on the PatchSet and
    gives the same bits on every call."""
    from alfi_torch.mg.patches import contract_patch_tensors

    t = cav2["t"]
    ps = t.vmg.patchsets[0]
    T = torch.as_tensor(_rand((t.mesh.num_cells, 42, 42), 35))
    A1 = contract_patch_tensors(ps, T)
    cells, flat = ps._contract_cache[T.device]
    A2 = contract_patch_tensors(ps, T)
    assert ps._contract_cache[T.device][1] is flat
    assert A1.shape == (125, 189, 189) and torch.equal(A1, A2)
    # against a loop over (patch, cell) pairs
    l2p = np.asarray(ps.l2p)
    ref = np.zeros((3, 190, 190))
    for p in range(3):
        for c, cell in enumerate(ps.cells[p]):
            if cell < t.mesh.num_cells:
                np.add.at(ref[p], (l2p[p, c][:, None], l2p[p, c][None, :]),
                          T[cell].numpy())
    assert _rel(A1[:3], ref[:, :189, :189]) < 1e-14


# ----------------------------------------------------------------------
# (c) one full-multigrid cycle
# ----------------------------------------------------------------------
def test_3d_fmg_cycle_matches_jax(cav2):
    t, j = cav2["t"], cav2["j"]
    nv, nq = t.Z.V.ndof, t.Z.Q.ndof
    mask = t.bcset.mask[0].numpy()
    u = mask * 0.1 * _rand((nv, 3), 41) + t.bcset.values[0].numpy()
    p = _rand((nq,), 42)
    rv = mask * _rand((nv, 3), 43)
    tstate = t.vmg.setup(torch.as_tensor(u), PARAMS,
                         schoeberl_state=t._transfer_setup(PARAMS),
                         static=t._almg_static)
    out_t = t.vmg.make_solve_A(tstate)(torch.as_tensor(rv))
    jv = j.vmg

    @jax.jit
    def jax_solve(z, r, ts, st):
        state = jv.setup(z[0], PARAMS, schoeberl_state=ts, static=st,
                         p_fine=z[1])
        return jv.make_solve_A(state)(r)

    out_j = jax_solve((jnp.asarray(u), jnp.asarray(p)), jnp.asarray(rv),
                      j._transfer_setup(PARAMS), j._almg_static)
    assert _rel(out_t, out_j) < 1e-7


# ----------------------------------------------------------------------
# (d) whole solves, (e) with SUPG and the Schoeberl restriction
# ----------------------------------------------------------------------
def test_3d_settings_equal_jax(cav2):
    """Smoothing 10 and the 3D tolerances (alfi_tpu/solver.py:107-110,
    200-211)."""
    t, j = cav2["t"], cav2["j"]
    assert t.smoothing == j.smoothing == 10
    assert t.tolerances == j.tolerances == dict(
        ksp_rtol=1e-8, ksp_atol=1e-8, snes_rtol=1e-8, snes_atol=1e-8,
        snes_stol=1e-6)
    assert t.Z.dim == j.Z.dim == 5163
    assert t.vmg.stab is None


@pytest.mark.parametrize("re, counts", [(1, (6, 2)), (10, (5, 2))])
def test_p2fb_counts_equal_jax(cav2, re, counts):
    tres, jres = cav2["tres"], cav2["jres"]
    assert tres[re]["converged"] and jres[re]["converged"]
    assert _counts(tres[re]) == _counts(jres[re]) == counts


def test_p2fb_state_agrees_with_jax(cav2):
    for a, b in zip(cav2["zt"], cav2["zj"]):
        assert _rel(a, b) < 1e-8


@pytest.mark.parametrize("re, counts", [(1, (9, 2)), (10, (6, 2))])
def test_p1fb_counts_equal_jax(cav1, re, counts):
    _, _, rec = cav1
    _, it, _, ij = rec[re]
    assert it["converged"] and ij["converged"]
    assert _counts(it) == _counts(ij) == counts


@pytest.mark.parametrize("re", RES)
def test_p1fb_states_agree_with_jax(cav1, re):
    zt, _, zj, _ = cav1[2][re]
    assert cav1[0].Z.dim == 3351
    for a, b in zip(zt, zj):
        assert _rel(a, b) < 1e-8


@pytest.mark.parametrize("re", RES)
def test_supg_restriction_counts_equal_jax(supg2, re):
    t, j, rec = supg2
    zt, it, zj, ij = rec[re]
    assert t.stabilisation.impl.weight == j.stabilisation.impl.weight == 0.1
    assert it["converged"] and ij["converged"]
    assert _counts(it) == _counts(ij)
    for a, b in zip(zt, zj):
        assert _rel(a, b) < 1e-8


# ----------------------------------------------------------------------
# 3D checkpoints both ways
# ----------------------------------------------------------------------
def _forbid(solver):
    def no_solve(re):
        raise AssertionError("solved Re=%s instead of loading it" % re)
    solver.solve = no_solve


def test_port_loads_jax_3d_checkpoints(cav2):
    t = TorchSolver(TorchLDC3(2), k=2, device="cpu", **KW)
    _forbid(t)
    res = _in_dir(cav2["jdir"],
                  lambda: tdriver.run_solver(t, RES, cav2["targs"]))
    assert all(res[re]["checkpointed"] for re in RES)
    assert [_counts(res[re]) for re in RES] == \
        [_counts(cav2["jres"][re]) for re in RES]
    assert t.z[0].shape == (t.Z.V.ndof, 3)
    for a, b in zip(t.z, cav2["zj"]):
        assert np.array_equal(a.numpy(), b)


def test_jax_loads_port_3d_checkpoints(cav2):
    j = cav2["j"]
    solve = j.solve
    _forbid(j)
    try:
        res = _in_dir(cav2["tdir"],
                      lambda: jdriver.run_solver(j, RES, cav2["jargs"]))
    finally:
        j.solve = solve
    assert all(res[re]["checkpointed"] for re in RES)
    assert [_counts(res[re]) for re in RES] == \
        [_counts(cav2["tres"][re]) for re in RES]
    assert sorted(os.listdir(os.path.join(cav2["tdir"], "checkpoint"))) == \
        ["5163"]
    for a, b in zip(j.z, cav2["zt"]):
        assert np.array_equal(np.asarray(a), b)


# ----------------------------------------------------------------------
# (f) the 3D backwards-facing step: an outflow, no pressure null space
# ----------------------------------------------------------------------
def test_bfs3d_fixture_problem_equals_jax():
    """The gmsh fixture read by both packages' step problems: the same
    mesh, inflow profile and boundary tags, and no null space."""
    msh = os.path.join(REPO, "tests", "fixtures", "bfs3d_coarse55.msh")
    pt, pj = TorchBFS3(msh), JaxBFS3(msh)
    mt, mj = pt.mesh(), pj.mesh()
    assert mt.num_cells == 1184
    assert np.array_equal(mt.cells, mj.cells)
    assert np.array_equal(mt.vertices, mj.vertices)
    assert np.array_equal(mt.facet_markers, mj.facet_markers)
    assert set(np.unique(mt.facet_markers)) >= {1, 3}
    x = np.abs(_rand((50, 3), 51)) + np.array([0.0, 0.5, 0.0])
    assert np.array_equal(pt.poiseuille_flow(x), pj.poiseuille_flow(x))
    assert not pt.has_nullspace() and not pj.has_nullspace()


def test_bfs3d_newton_step_matches_jax():
    """One Newton linear step of [P1+FB]^3 on the generated step mesh
    (912 cells at nref=1) with SUPG and the Schoeberl restriction, from a
    seeded state: equal Krylov counts, updates to 1e-8.  No null-space
    projector is in the loop."""
    kw = dict(KW, k=1, stabilisation_type="supg", stabilisation_weight=0.05,
              restriction=True)
    t = TorchSolver(TorchBFS3(n=1), device="cpu", **kw)
    j = JaxSolver(JaxBFS3(n=1), **kw)
    assert not t.nsp and not j.nsp and t.Z.dim == j.Z.dim
    mask = t.bcset.mask[0].numpy()
    u = mask * 0.05 * _rand((t.Z.V.ndof, 3), 52) + t.bcset.values[0].numpy()
    p = 0.1 * _rand((t.Z.Q.ndof,), 53)
    for s in (t, j):
        s.nu_val, s.advect_val = 1.0 / 10, 1.0
    z_t = (torch.as_tensor(u), torch.as_tensor(p))
    z_j = (jnp.asarray(u), jnp.asarray(p))
    t.z_last, j.z_last = z_t, z_j
    pt, pj = t.params(), j.params()
    F_t = t.residual_masked(z_t, pt)
    F_j = j.residual_masked(z_j, pj)
    for a, b in zip(F_t, F_j):
        assert _rel(a, b) < 1e-11
    dz_t, its_t = t._linear_step(z_t, F_t, pt, t._transfer_setup(pt))
    dz_j, its_j = j._linear_step(z_j, F_j, pj, j._transfer_setup(pj))
    assert its_t == int(its_j)
    for a, b in zip(dz_t, dz_j):
        assert _rel(a, b) < 1e-8
