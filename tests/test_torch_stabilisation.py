"""SUPG/GLS stabilisation of the port against the JAX package, on ldc2d
baseN=4 nref=1 ([P2]^2-P0, uniform hierarchy, gamma=1e4), f64 on the CPU:

* the residual hook's (Sv, Sq) for SUPG and GLS at a seeded state and
  frozen wind (Re=100 parameters): 1e-12 relative;
* the per-cell velocity-block Jacobians (Shakib SUPG analytic, Shakib GLS
  and Turek SUPG by jacfwd): 1e-11 relative; each is also the jacfwd of
  the port's own per-cell residual (1e-9), the analytic path is the
  same in cell chunks, and the hook vanishes for Stokes;
* VelocityMG.setup with the stabilised level operators: level tensors
  1e-10, patch inverses 1e-7 (explicit inverses at kappa ~ 1e8), one FMG
  cycle 1e-7;
* the whole SUPG solve with --restriction over Re 1, 10, 100: equal
  Krylov/Newton counts in the same test, states 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_torch.stabilisation import make_stabilisation as torch_stab
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.mg.patches import assemble_patch_matrices
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC
from alfi_tpu.stabilisation import make_stabilisation as jax_stab

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          stabilisation_type="supg", restriction=True, verbose=False)
#: Re=100 on the cavity (char length 2, char velocity 1)
PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}
VARIANTS = [("shakib", "supg"), ("shakib", "gls"), ("turek", "supg")]
RES = [1, 10, 100]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solvers():
    torch.set_num_threads(1)
    return (TorchSolver(TorchLDC(4), device="cpu", **KW),
            JaxSolver(JaxLDC(4), **KW))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _state(t, seed):
    """Seeded (u, p, wind) on the fine level, BC rows at their values."""
    rng = np.random.default_rng(seed)
    nv, nq = t.Z.V.ndof, t.Z.Q.ndof
    mask, vals = t.bcset.mask[0].numpy(), t.bcset.values[0].numpy()
    u = mask * 0.5 * rng.standard_normal((nv, 2)) + vals
    p = rng.standard_normal(nq)
    wind = mask * 0.5 * rng.standard_normal((nv, 2)) + vals
    return u, p, wind


def _pair(solvers, method, kind):
    t, j = solvers
    return (torch_stab(t.form, kind, method, 9.0, None, char_LU=2.0),
            jax_stab(j.form, kind, method, 9.0, None, char_LU=2.0))


def _params(wind, advect=1.0):
    pt = dict(PARAMS, advect=advect, wind=torch.as_tensor(wind))
    pj = dict(PARAMS, advect=advect, wind=jnp.asarray(wind))
    return pt, pj


@pytest.mark.parametrize("kind", ["supg", "gls"])
def test_hook_matches_jax(solvers, kind):
    st, sj = _pair(solvers, "shakib", kind)
    u, p, wind = _state(solvers[0], 0)
    pt, pj = _params(wind)
    Sv_t, Sq_t = st.residual_hook((torch.as_tensor(u), torch.as_tensor(p)),
                                  pt)
    Sv_j, Sq_j = sj.residual_hook((jnp.asarray(u), jnp.asarray(p)), pj)
    assert float(np.abs(np.asarray(Sv_j)).max()) > 0
    assert _rel(Sv_t, Sv_j) < 1e-12
    if kind == "supg":  # SUPG tests only the velocity rows
        assert not Sq_t.any() and not np.asarray(Sq_j).any()
    else:
        assert _rel(Sq_t, Sq_j) < 1e-12


@pytest.mark.parametrize("method,kind", VARIANTS)
def test_velocity_element_tensors_match_jax(solvers, method, kind):
    st, sj = _pair(solvers, method, kind)
    u, p, wind = _state(solvers[0], 1)
    pt, pj = _params(wind)
    Tt = st.velocity_tensors_hook(
        (torch.as_tensor(u), torch.as_tensor(p)), pt)
    Tj = sj.velocity_tensors_hook((jnp.asarray(u), jnp.asarray(p)), pj)
    assert _rel(Tt, Tj) < 1e-11


@pytest.mark.parametrize("method,kind", VARIANTS)
def test_velocity_element_tensors_are_the_residual_jacobian(solvers,
                                                            method, kind):
    """The twin of tests/test_stabilisation.py::
    test_supg_velocity_tensors_match_jvp: the per-cell Jacobian the MG
    operators use equals torch.func.jacfwd of the port's own per-cell
    residual (the code the residual hook runs)."""
    st, _ = _pair(solvers, method, kind)
    impl = st.impl
    form = impl.form
    u, p, wind = _state(solvers[0], 2)
    pt, _ = _params(wind)
    u_loc = torch.as_tensor(u)[form.cd_v]
    p_loc = torch.as_tensor(p)[form.cd_q]
    w_loc = pt["wind"][form.cd_v]
    aux = impl.aux_global(pt)
    geom = form.geom

    def one(ul, pl, wl, ji, dj, hc):
        rv, _ = impl.residual_local(ul[None], pl[None], wl[None], ji[None],
                                    dj[None], hc[None], pt, aux)
        return rv[0]

    J = torch.func.vmap(torch.func.jacfwd(one))(
        u_loc, p_loc, w_loc, geom.jinv, geom.detj, impl.h)
    nc, nl, d = J.shape[:3]
    T = st.velocity_tensors_hook((torch.as_tensor(u), torch.as_tensor(p)),
                                 pt)
    assert _rel(T, J.reshape(nc, nl * d, nl * d)) < 1e-9


def test_supg_analytic_chunked_matches_unchunked(solvers):
    st, _ = _pair(solvers, "shakib", "supg")
    impl = st.impl
    form = impl.form
    u, p, wind = _state(solvers[0], 3)
    pt, _ = _params(wind)
    geom = form.geom
    args = (pt, torch.as_tensor(u)[form.cd_v], torch.as_tensor(p)[form.cd_q],
            geom.jinv, geom.detj, impl.h)
    nc = geom.detj.shape[0]
    J_one = impl._vet_supg_analytic(*args, chunk=nc + 1)
    # a chunk that does not divide nc: the short tail chunk
    assert nc % 48
    J_chunked = impl._vet_supg_analytic(*args, chunk=48)
    assert _rel(J_chunked, J_one) < 1e-14


@pytest.mark.parametrize("kind", ["supg", "gls"])
def test_hook_vanishes_for_stokes(solvers, kind):
    st, _ = _pair(solvers, "shakib", kind)
    u, p, wind = _state(solvers[0], 4)
    pt, _ = _params(wind, advect=0.0)
    Sv, Sq = st.residual_hook((torch.as_tensor(u), torch.as_tensor(p)), pt)
    assert not Sv.any() and not Sq.any()


# ----------------------------------------------------------------------
# the stabilised level and patch operators
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def setups(solvers):
    """VelocityMG.setup in both packages at one seeded state."""
    t, j = solvers
    u, p, wind = _state(t, 5)
    pt, pj = _params(wind)
    st_t = t.vmg.setup(torch.as_tensor(u), pt,
                       schoeberl_state=t._transfer_setup(pt),
                       static=t._almg_static, p_fine=torch.as_tensor(p))
    jv = j.vmg

    @jax.jit
    def jax_tensors(z, P, ts, st):
        return jv.setup(z[0], P, schoeberl_state=ts, static=st,
                        p_fine=z[1])["tensors"]

    zj = (jnp.asarray(u), jnp.asarray(p))
    tens_j = jax_tensors(zj, pj, j._transfer_setup(pj), j._almg_static)
    return st_t, tens_j, (u, p, pt, pj)


@pytest.mark.parametrize("level", [0, 1])
def test_stabilised_level_tensors_match_jax(setups, level):
    st_t, tens_j, _ = setups
    assert _rel(st_t["tensors"][level], tens_j[level]) < 1e-10


def test_stabilised_patch_inverses_match_jax(solvers, setups):
    """The port's explicit patch inverses against the inverses of the
    JAX package's patch matrices, assembled from its stabilised level
    tensors."""
    _, j = solvers
    st_t, tens_j, _ = setups
    Aj = np.asarray(assemble_patch_matrices(j.vmg.patchsets[0], tens_j[1]))
    assert _rel(st_t["patch_lufacs"][0], np.linalg.inv(Aj)) < 1e-7


def test_stabilised_fmg_solve_A_matches_jax(solvers, setups):
    t, j = solvers
    st_t, _, (u, p, pt, pj) = setups
    rv = t.bcset.mask[0].numpy() * np.random.default_rng(6).standard_normal(
        (t.Z.V.ndof, 2))
    out_t = t.vmg.make_solve_A(st_t)(torch.as_tensor(rv))
    jv = j.vmg

    @jax.jit
    def jax_solve(z, r, P, ts, st):
        state = jv.setup(z[0], P, schoeberl_state=ts, static=st,
                         p_fine=z[1])
        return jv.make_solve_A(state)(r)

    out_j = jax_solve((jnp.asarray(u), jnp.asarray(p)), jnp.asarray(rv), pj,
                      j._transfer_setup(pj), j._almg_static)
    assert _rel(out_t, out_j) < 1e-7


def test_stabilised_setup_needs_the_pressure(solvers):
    t, _ = solvers
    u, _, wind = _state(t, 7)
    pt, _ = _params(wind)
    with pytest.raises(ValueError, match="p_fine"):
        t.vmg.setup(torch.as_tensor(u), pt,
                    schoeberl_state=t._transfer_setup(pt),
                    static=t._almg_static)


# ----------------------------------------------------------------------
# the whole SUPG solve
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sweeps():
    torch.set_num_threads(1)
    t = TorchSolver(TorchLDC(4), device="cpu", **KW)
    j = JaxSolver(JaxLDC(4), **KW)
    rec = {}
    for re in RES:
        zt, it = t.solve(re)
        zj, ij = j.solve(re)
        rec[re] = ([x.numpy().copy() for x in zt], it,
                   [np.asarray(x) for x in zj], ij)
    return rec


@pytest.mark.parametrize("re", RES)
def test_supg_counts_equal_jax(sweeps, re):
    _, it, _, ij = sweeps[re]
    assert it["converged"] and ij["converged"]
    assert (it["linear_iter"], it["nonlinear_iter"]) == \
        (int(ij["linear_iter"]), int(ij["nonlinear_iter"]))


@pytest.mark.parametrize("re", RES)
def test_supg_states_agree_with_jax(sweeps, re):
    zt, _, zj, _ = sweeps[re]
    for a, b in zip(zt, zj):
        assert _rel(a, b) < 1e-8
