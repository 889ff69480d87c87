"""Burman's interior-penalty stabilisation of the port against the JAX
package, f64 on the CPU, same inputs from a numpy seed through both:
ldc2d SV k=2 on bary with macrostar patches, baseN=4 nref=1, Burman
weight 5e-3 (the configuration of tests/test_burman_pc.py), and the 3D
tables of SV k=3 at baseN=1.

* ``InteriorFacets`` tables entry by entry (2D and 3D);
* the Burman residual and the per-facet Jacobians (1e-12), which are
  also the residual's own Jacobian;
* ``patch_facet_tables`` entry by entry (2D and 3D) and their
  contraction (1e-12); the dense coarse assembly with facet tensors;
* ``VelocityMG.setup``'s level and facet tensors (1e-11), the patch
  matrices (1e-12), ``level_apply`` with facets (1e-12) and one FMG cycle
  (1e-7: explicit inverses at kappa ~ 1e8 against LU solves);
* the twins of test_burman_pc.py's three tests, the solve with the JAX
  package's counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ScottVogeliusSolver as TorchSV
from alfi_torch import fem as tfem
from alfi_torch.fem.facets import InteriorFacets as TorchFacets
from alfi_torch.mg.patches import FacetPatchTables
from alfi_torch.mg.patches import assemble_patch_matrices as torch_apm
from alfi_torch.mg.patches import contract_patch_facet_tensors as torch_cpft
from alfi_torch.mg.patches import macrostar_patches as torch_macrostar
from alfi_torch.mg.patches import patch_padding_diag
from alfi_torch.parallel.dryrun import jvp_linear_step
from alfi_torch.problems import ThreeDimLidDrivenCavityProblem as TorchLDC3
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_torch.solvers.linear import assemble_dense_from_tensors as torch_ad
from alfi_torch.solvers.linear import make_jacobian_matvec
from alfi_torch.stabilisation import BurmanStabilisation as TorchBurman
from alfi_torch.utils.tree import tnorm
from alfi_tpu import ScottVogeliusSolver as JaxSV
from alfi_tpu import fem as jfem
from alfi_tpu.fem.facets import InteriorFacets as JaxFacets
from alfi_tpu.mg.patches import assemble_patch_matrices as jax_apm
from alfi_tpu.mg.patches import contract_patch_facet_tensors as jax_cpft
from alfi_tpu.mg.patches import macrostar_patches as jax_macrostar
from alfi_tpu.mg.patches import patch_facet_tables as jax_pft
from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem as JaxLDC3
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC
from alfi_tpu.solvers.linear import assemble_dense_from_tensors as jax_ad
from alfi_tpu.stabilisation import BurmanStabilisation as JaxBurman

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="bary", patch="macro",
          stabilisation_type="burman", stabilisation_weight=5e-3, gamma=1e4,
          verbose=False)
PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _newton_step(solver, linear_step=None):
    """One Newton step from rest at Re=100 (test_burman_pc's fixture), by
    ``linear_step`` (default: the solver's own)."""
    solver.advect_val = 1.0
    solver.nu_val = solver.char_L * solver.char_U / 100.0
    params = solver.params()
    F = solver.residual_masked(solver.z, params)
    tstate = solver._transfer_setup(params)
    lin = solver._linear_step if linear_step is None else linear_step
    dz, _ = lin(solver.z, F, params, tstate)
    solver.z = (solver.z[0] + dz[0], solver.z[1] + dz[1])


@pytest.fixture(scope="module")
def solvers():
    torch.set_num_threads(1)
    t, j = TorchSV(TorchLDC(4), device="cpu", **KW), JaxSV(JaxLDC(4), **KW)
    _newton_step(t)
    _newton_step(j)
    return t, j


def _seeded_u(t, seed):
    rng = np.random.default_rng(seed)
    mask, vals = t.bcset.mask[0].numpy(), t.bcset.values[0].numpy()
    return mask * 0.5 * rng.standard_normal((t.Z.V.ndof, 2)) + vals


def _forms_3d():
    """(torch, JAX) SV k=3 forms on the levels of ldc3d baseN=1 bary."""
    out = []
    for fem, problem, kw in ((tfem, TorchLDC3(1), {"device": "cpu"}),
                             (jfem, JaxLDC3(1), {})):
        forms = []
        for mesh in problem.mesh_hierarchy("bary", 1):
            V = fem.VectorFunctionSpace(mesh, fem.lagrange(3, 3))
            Q = fem.FunctionSpace(mesh, fem.dg_lagrange(3, 2))
            forms.append(fem.NSForm(V, Q, "exact", **kw))
        out.append(forms)
    return out


@pytest.fixture(scope="module")
def forms3d():
    return _forms_3d()


def _same_facets(ft, fj):
    assert ft.nif == fj.nif and ft.nq == fj.nq
    assert np.array_equal(ft.facets, np.asarray(fj.facets))
    for key in ("cells", "config"):
        assert np.array_equal(getattr(ft, key), np.asarray(getattr(fj, key)))
    for key in ("normal", "scale", "harea", "w", "tab", "gtab"):
        assert _rel(getattr(ft, key), getattr(fj, key)) < 1e-14, key


def test_interior_facets_match_jax_2d(solvers):
    t, j = solvers
    ft, fj = t.stabilisation.impl.facets, j.stabilisation.impl.facets
    assert isinstance(ft, TorchFacets) and ft.nq == 3
    _same_facets(ft, fj)


def test_interior_facets_match_jax_3d(forms3d):
    (tf, jf) = (forms3d[0][1], forms3d[1][1])
    _same_facets(TorchFacets(tf.V, 6, device="cpu"), JaxFacets(jf.V, 6))


def test_burman_residual_matches_jax(solvers):
    t, j = solvers
    u = _seeded_u(t, 0)
    p = np.random.default_rng(1).standard_normal(t.Z.Q.ndof)
    Rt = t.stabilisation.residual_hook(
        (torch.as_tensor(u), torch.as_tensor(p)), PARAMS)
    Rj = j.stabilisation.residual_hook(
        (jnp.asarray(u), jnp.asarray(p)),
        {k: jnp.asarray(v) for k, v in PARAMS.items()})
    assert float(np.abs(np.asarray(Rj[0])).max()) > 0
    assert _rel(Rt[0], Rj[0]) < 1e-12
    assert not Rt[1].any()


def test_facet_velocity_tensors_match_jax(solvers):
    t, j = solvers
    u = _seeded_u(t, 2)
    Jt = t.stabilisation.impl.facet_velocity_tensors(torch.as_tensor(u),
                                                     PARAMS)
    Jj = j.stabilisation.impl.facet_velocity_tensors(jnp.asarray(u), PARAMS)
    assert Jt.shape == (t.stabilisation.impl.facets.nif, 24, 24)
    assert _rel(Jt, Jj) < 1e-12


def test_facet_velocity_tensors_match_jax_3d(forms3d):
    tf, jf = forms3d[0][0], forms3d[1][0]
    bt, bj = TorchBurman(tf, 5e-3), JaxBurman(jf, 5e-3)
    u = np.random.default_rng(3).standard_normal((tf.V.ndof, 3))
    Jt = bt.facet_velocity_tensors(torch.as_tensor(u), PARAMS)
    Jj = bj.facet_velocity_tensors(jnp.asarray(u), PARAMS)
    assert Jt.shape[1:] == (120, 120)
    assert _rel(Jt, Jj) < 1e-12
    r = np.random.default_rng(4).standard_normal((tf.Q.ndof,))
    Rt, _ = bt.residual((torch.as_tensor(u), torch.as_tensor(r)), PARAMS)
    Rj, _ = bj.residual((jnp.asarray(u), jnp.asarray(r)), PARAMS)
    assert _rel(Rt, Rj) < 1e-12


def test_facet_tensors_are_the_residual_jacobian(solvers):
    """Summed over the facet rows, the per-facet Jacobians act as the jvp
    of the assembled Burman residual."""
    t, _ = solvers
    st = t.stabilisation.impl
    u = torch.as_tensor(_seeded_u(t, 5))
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(u.shape))
    p = torch.zeros(t.Z.Q.ndof, dtype=torch.float64)
    _, jv = torch.func.jvp(lambda uu: st.residual((uu, p), PARAMS)[0],
                           (u,), (v,))
    frows = t.vmg.facet_rows[-1]
    Jf = st.facet_velocity_tensors(u, PARAMS)
    vf = v.reshape(-1)[torch.as_tensor(frows)]
    got = torch.zeros(v.numel(), dtype=torch.float64).index_add(
        0, torch.as_tensor(frows).reshape(-1),
        torch.einsum("fij,fj->fi", Jf, vf).reshape(-1))
    assert _rel(got.reshape(v.shape), jv) < 1e-12


def test_patch_facet_tables_match_jax_2d(solvers):
    t, j = solvers
    ft = t.vmg.patch_facet_tabs[0]
    pf, fl2p = j.vmg.patch_facet_tabs[0]
    assert np.array_equal(ft.pfacets, np.asarray(pf))
    assert np.array_equal(ft.fl2p, np.asarray(fl2p))
    nif = t.stabilisation.impl.facets.nif
    Jf = np.random.default_rng(7).standard_normal((nif, 24, 24))
    assert _rel(torch_cpft(ft, torch.as_tensor(Jf)),
                jax_cpft(pf, fl2p, jnp.asarray(Jf), ft.m)) < 1e-12


def test_patch_facet_tables_match_jax_3d(forms3d):
    tf, jf = forms3d[0][1], forms3d[1][1]
    mask = np.ones(tf.V.ndof * 3)
    pt, pj = torch_macrostar(tf.V, mask), jax_macrostar(jf.V, mask)
    ft = FacetPatchTables(pt, TorchFacets(tf.V, 6, device="cpu"), tf.V)
    pf, fl2p = jax_pft(pj, JaxFacets(jf.V, 6), jf.V)
    assert np.array_equal(ft.pfacets, np.asarray(pf))
    assert np.array_equal(ft.fl2p, np.asarray(fl2p))


def test_dense_assembly_with_facets_matches_jax(solvers):
    t, j = solvers
    lt, lj = t.vmg.levels[0], j.vmg.levels[0]
    rng = np.random.default_rng(8)
    T = rng.standard_normal(tuple(lt.form._static_velocity_tensors()[0]
                                  .shape))
    nif = t.vmg.stab_facet[0].facets.nif
    F = rng.standard_normal((nif, 24, 24))
    At = torch_ad(lt.form, torch.as_tensor(T), lt.mask_u,
                  facet_tensors=torch.as_tensor(F),
                  facet_rows=t.vmg.facet_rows[0])
    Aj = jax_ad(lj.form, jnp.asarray(T), lj.mask_u,
                facet_tensors=jnp.asarray(F),
                facet_rows=j.vmg.facet_rows[0])
    assert _rel(At, Aj) < 1e-12


@pytest.fixture(scope="module")
def states(solvers):
    """VelocityMG.setup of both packages at a seeded state (Re=100
    parameters), and the JAX FMG cycle of a seeded right-hand side."""
    t, j = solvers
    u = _seeded_u(t, 9)
    p = np.random.default_rng(10).standard_normal(t.Z.Q.ndof)
    rv = t.bcset.mask[0].numpy() * np.random.default_rng(11).standard_normal(
        u.shape)
    pt = dict(PARAMS, wind=torch.as_tensor(u))
    st = t.vmg.setup(torch.as_tensor(u), pt,
                     schoeberl_state=t._transfer_setup(pt),
                     static=t._almg_static, p_fine=torch.as_tensor(p))
    jv = j.vmg
    pj = dict(PARAMS, wind=jnp.asarray(u))

    @jax.jit
    def jax_setup(z, r, ts, static):
        state = jv.setup(z[0], pj, schoeberl_state=ts, static=static,
                         p_fine=z[1])
        return state, jv.make_solve_A(state)(r)

    sj, out_j = jax_setup((jnp.asarray(u), jnp.asarray(p)), jnp.asarray(rv),
                          j._transfer_setup(pj), j._almg_static)
    return u, rv, st, sj, out_j


def test_setup_tensors_match_jax(states):
    _, _, st, sj, _ = states
    for l in range(2):
        assert _rel(st["tensors"][l], sj["tensors"][l]) < 1e-11
        assert _rel(st["ftensors"][l], sj["ftensors"][l]) < 1e-11


def test_patch_matrices_match_jax(solvers, states):
    t, j = solvers
    _, _, st, sj, _ = states
    ps_t, ps_j = t.vmg.patchsets[0], j.vmg.patchsets[0]
    At = (torch_apm(ps_t, st["tensors"][1])
          + torch_cpft(t.vmg.patch_facet_tabs[0], st["ftensors"][1]))
    pf, fl2p = j.vmg.patch_facet_tabs[0]
    Aj = (jax_apm(ps_j, sj["tensors"][1])
          + jax_cpft(pf, fl2p, sj["ftensors"][1], ps_j.m))
    assert _rel(At, Aj) < 1e-12
    inv = st["patch_lufacs"][0]
    eye = torch.eye(ps_t.m, dtype=torch.float64)
    assert float((torch.bmm(At, inv) - eye).abs().max()) < 1e-6


def test_level_apply_with_facets_matches_jax(solvers, states):
    t, j = solvers
    _, _, st, sj, _ = states
    v = np.random.default_rng(12).standard_normal((t.Z.V.ndof, 2))
    for l in range(2):
        nl = t.vmg.levels[l].V.ndof
        vals = t.vmg.level_assemble(l, st["tensors"][l], st["ftensors"][l])
        out_t = t.vmg.level_apply(l, vals, torch.as_tensor(v[:nl]))
        out_j = j.vmg.level_apply(l, sj["tensors"][l], jnp.asarray(v[:nl]),
                                  ftensors=sj["ftensors"][l])
        assert _rel(out_t, out_j) < 1e-12


def test_fmg_with_facets_matches_jax(solvers, states):
    t, _ = solvers
    _, rv, st, _, out_j = states
    out_t = t.vmg.make_solve_A(st)(torch.as_tensor(rv))
    assert _rel(out_t, out_j) < 1e-7


def test_newton_step_matches_jax(solvers):
    """The port's Newton step by the JAX package's algorithm (the outer
    FGMRES on the jvp of the residual) within 1e-8 of the JAX package's.
    The port's own step (the fixture's) applies the MG set-up's assembled
    operator, the same Jacobian rounded otherwise
    (test_torch_outer_jacobian.py); FGMRES determines a step only to its
    rtol, and that rounding moves this one by ~1e-7, so the port's own
    step is held to the criterion it is solved by: the jvp's Jacobian
    system to ksp_rtol."""
    t, j = solvers
    s = TorchSV(TorchLDC(4), device="cpu", **KW)
    _newton_step(s, jvp_linear_step(s))
    for a, b in zip(s.z, j.z):
        assert _rel(a, b) < 1e-8
    rest, params = s.bcset.apply(s.Z.zero(s.device)), s.params()
    F = s.residual_masked(rest, params)
    J = make_jacobian_matvec(s.form.residual, s.bcset, rest, params)
    dz = tuple(a - b for a, b in zip(t.z, rest))
    r = tuple(x + f for x, f in zip(J(dz), F))
    assert float(tnorm(r)) <= t.tolerances["ksp_rtol"] * float(tnorm(F))


def test_fine_level_operator_matches_jacobian(solvers):
    """Twin of test_burman_pc.py: level_apply with facet tensors is the
    velocity block of the true stabilised Jacobian (the jvp of the full
    residual, Burman's dS term included)."""
    t, _ = solvers
    vmg = t.vmg
    assert vmg.stab_facet is not None
    params = t.params()
    L = vmg.nlevels - 1
    state = vmg.setup(t.z[0], params, schoeberl_state=t._transfer_setup(
        params), static=t._almg_static, p_fine=t.z[1])
    mask = t.bcset.mask[0]
    v = mask * torch.as_tensor(
        np.random.default_rng(3).standard_normal(t.z[0].shape))
    lhs = vmg.level_apply(L, state["level_ops"][L], v)
    p0 = t.z[1]
    _, jv = torch.func.jvp(
        lambda u: t.residual_masked((u, p0), params)[0], (t.z[0],), (v,))
    rhs = mask * jv + (1.0 - mask) * v
    assert float((lhs - rhs).norm() / rhs.norm()) < 1e-11


def test_patch_matrices_match_dense_restriction(solvers):
    """Twin of test_burman_pc.py: the stabilised patch operator is the
    global stabilised Jacobian restricted to the patch dofs."""
    t, _ = solvers
    vmg = t.vmg
    params = t.params()
    L = vmg.nlevels - 1
    state = vmg.setup(t.z[0], params, schoeberl_state=t._transfer_setup(
        params), static=t._almg_static, p_fine=t.z[1])
    ps = vmg.patchsets[L - 1]
    Ap = (torch_apm(ps, state["tensors"][L])
          + torch_cpft(vmg.patch_facet_tabs[L - 1], state["ftensors"][L]))
    ar = torch.arange(ps.m)
    Ap[:, ar, ar] -= patch_padding_diag(ps, Ap.dtype, Ap.device)
    lev = vmg.levels[L]
    Adense = torch_ad(lev.form, state["tensors"][L], lev.mask_u,
                      facet_tensors=state["ftensors"][L],
                      facet_rows=vmg.facet_rows[L]).numpy()
    Ap = Ap.numpy()
    rng = np.random.default_rng(0)
    for p in rng.integers(0, ps.npatches, 8):
        dofs = ps.dofs[p][ps.active[p]]
        sub = Adense[np.ix_(dofs, dofs)]
        got = Ap[p][: len(dofs), : len(dofs)]
        assert np.abs(got - sub).max() < 1e-10 * (1.0 + np.abs(sub).max())


def test_burman_pc_solve_converges(solvers):
    """Twin of test_burman_pc.py: the SV solve with the facet-coupled PC
    converges at Re 10 and 100 with the JAX package's counts (kpn < 25)."""
    counts = []
    for s, zero in zip(solvers, ({"device": "cpu"}, {})):
        s.z = s.bcset.apply(s.Z.zero(**zero))
        s.z_last = s.z
        row = []
        for re in [10, 100]:
            _, info = s.solve(re)
            assert info["converged"], re
            row.append((info["linear_iter"], info["nonlinear_iter"]))
        counts.append(row)
        assert row[-1][0] / max(1, row[-1][1]) < 25
    assert counts[0] == counts[1]
