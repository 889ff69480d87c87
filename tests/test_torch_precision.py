"""The precision modes of the port's velocity multigrid against the JAX
package (``alfi_tpu/config.py``: ``mg_dtype``, ``mg_store``,
``mg_smooth_dtype``), on the CPU; and the kernels of those modes (K1 in
f32, KM in its three mixed modes, KB) against their plain versions on a
card only.

Twins of ``tests/test_mixed_cycle.py``:

* the state dtypes of each mode: only what the mode narrows is narrowed,
  the coarse factor stays f64, the f32 cycle's Schoeberl state is f32 LU
  factors;
* the gamma-split apply of the f32 cycle matches the f64 apply to 1e-5
  and keeps the grad-div term's cancellation on a discretely
  divergence-free field (split < 3e-6, the all-f32 summed apply > 30x
  that);
* a Jacobi-smoothed f32 cycle stores the split too, its diagonal read off
  the f64 sum.

Against the JAX package, same seeded inputs through both:

* one ``make_solve_A`` application per mode at ldc2d baseN=4 nref=1, at
  Re 1's viscosity: 1e-4 relative in the f32 modes; at Re 100's (nu =
  0.02), where the two differ by up to 1.8e-3, each package's own f32
  rounding is the cause: the port departs from its own f64 apply by at
  most 1.5 times what the JAX package departs from its own, which is
  past 1e-4 wherever the two differ past it (the sweeps of
  ``test_torch_precision_solve.py`` hold the counts there); the f32
  cycle's Schoeberl solve by f32 LU factors (kernel KL) the same way,
  with both packages' ALFI_*_MG_F64_KEYS empty;
* KB's plain version against the JAX dict apply's grad-div part (both
  f64 from the same f64 factors) at 1e-12; the port's mg_store apply
  against the JAX dict apply of the same f32 values and f64 factors at
  1e-12, and against the JAX package's own mg_store apply at 1e-5 (the
  port rounds the merged sum to f32, the JAX package each cell's tensor);
* K1's f32 plain version against the Pallas kernel's plain-XLA form
  (``apply_transposed_xla``, f32, deleted in aaee1ce) at 1e-5;
* FGMRES and Chebyshev on f32 vectors keep every scalar f32 and match
  the JAX package's f32 recurrences at 1e-5.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import config as tconfig
from alfi_torch import kernels
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
MODES = ("dc32", "store32", "cycle32")
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _set_mode(mode):
    """Both packages' switches to ``mode`` (f64, dc32, store32, cycle32),
    through their setters."""
    import jax.numpy as jnp

    from alfi_tpu import config as jconfig

    for cfg, f32, f64 in ((tconfig, F32, F64),
                          (jconfig, jnp.float32, jnp.float64)):
        cfg.set_mg_dtype(f32 if mode == "cycle32" else f64)
        cfg.set_mg_store(f32 if mode in ("store32", "cycle32") else f64)
        cfg.set_mg_smooth_dtype(f32 if mode in ("dc32", "cycle32") else f64)


@pytest.fixture
def mode_of():
    yield _set_mode
    _set_mode("f64")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _torch_solver(baseN=8, **kw):
    return TorchSolver(TorchLDC(baseN), device="cpu", **dict(KW, **kw))


def _state(s, wind=None, params=None):
    """The port's per-Newton-step MG state of solver ``s``."""
    params = s.params() if params is None else params
    u = s.z[0] if wind is None else wind
    p = s.z[1] if s.stabilisation is not None else None
    return s.vmg.setup(u, params, s._transfer_setup(params),
                       s._almg_static, p_fine=p), params


def _full_f64(s, l, params, wind=None):
    """Level l's whole f64 operator (nu K + advect N + gamma G) merged."""
    form = s.vmg.levels[l].form
    K_el, G_el = form._static_velocity_tensors()
    T = params["nu"] * K_el + params["gamma"] * G_el
    if wind is not None:
        T = T + params["advect"] * form.advection_element_tensors(wind)
    return s.vmg.level_assemble(l, T)


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------
def test_config_reads_the_environment(monkeypatch):
    for var in ("ALFI_TORCH_MG_DTYPE", "ALFI_TORCH_MG_STORE",
                "ALFI_TORCH_MG_SMOOTH_DTYPE", "ALFI_TORCH_MG_F64_KEYS"):
        monkeypatch.delenv(var, raising=False)
    saved = (tconfig._mg_dtype, tconfig._mg_store, tconfig._mg_smooth)
    try:
        tconfig._mg_dtype = tconfig._mg_store = tconfig._mg_smooth = None
        assert (tconfig.mg_dtype(), tconfig.mg_store(),
                tconfig.mg_smooth_dtype()) == (F64, F64, F64)
        # none by default, as the JAX package's ALFI_TPU_MG_F64_KEYS
        assert tconfig.mg_f64_keys() == set()
        tconfig._mg_dtype = tconfig._mg_store = tconfig._mg_smooth = None
        monkeypatch.setenv("ALFI_TORCH_MG_DTYPE", "f32")
        # store and smoother default to the cycle dtype
        assert (tconfig.mg_dtype(), tconfig.mg_store(),
                tconfig.mg_smooth_dtype()) == (F32, F32, F32)
        tconfig._mg_dtype = tconfig._mg_store = tconfig._mg_smooth = None
        monkeypatch.delenv("ALFI_TORCH_MG_DTYPE")
        monkeypatch.setenv("ALFI_TORCH_MG_SMOOTH_DTYPE", "f32")
        monkeypatch.setenv("ALFI_TORCH_MG_STORE", "f64")
        assert (tconfig.mg_dtype(), tconfig.mg_store(),
                tconfig.mg_smooth_dtype()) == (F64, F64, F32)
        monkeypatch.setenv("ALFI_TORCH_MG_F64_KEYS", "patch_lufacs,tensors")
        assert tconfig.mg_f64_keys() == {"patch_lufacs", "tensors"}
        monkeypatch.setenv("ALFI_TORCH_MG_F64_KEYS", "")
        assert tconfig.mg_f64_keys() == set()
        tconfig._mg_dtype = None
        monkeypatch.setenv("ALFI_TORCH_MG_DTYPE", "bf16")
        with pytest.raises(ValueError, match="f32 or f64"):
            tconfig.mg_dtype()
    finally:
        tconfig._mg_dtype, tconfig._mg_store, tconfig._mg_smooth = saved


def test_velocity_mg_takes_the_modes_as_keywords():
    """The keywords override config; the defaults are config's, f64."""
    from alfi_torch.mg.velocity import VelocityMG

    s = _torch_solver(4)
    assert (s.vmg.cdt, s.vmg.sdt, s.vmg.mdt, s.vmg.split) == (F64, F64, F64,
                                                               False)
    v = VelocityMG(s, smooth_dtype=F32, store_dtype=F32)
    assert (v.cdt, v.sdt, v.mdt, v.split) == (F64, F32, F32, True)
    # under the Chebyshev driver the smoother runs in the cycle dtype, its
    # patch factors stored in the smoother dtype (the JAX package's): f32
    # LU factors, applied by kernel KL on f64 vectors
    v = VelocityMG(s, smoother_driver="chebyshev", cycle="w",
                   smooth_dtype=F32)
    assert (v.cdt, v.mdt, v.split) == (F64, F32, False)
    assert len(v.patch_lu) == v.nlevels - 1
    with pytest.raises(ValueError, match="f32 or f64"):
        VelocityMG(s, cycle_dtype=torch.bfloat16)


# ----------------------------------------------------------------------
# state dtypes (test_mixed_cycle.py:269-329)
# ----------------------------------------------------------------------
def test_smooth_f32_state_dtypes(mode_of):
    """Only the smoother's private state narrows: the patch inverses f32,
    the level operators, Schoeberl state and coarse factor f64."""
    mode_of("dc32")
    s = _torch_solver(stabilisation_type="supg")
    s.solve(1)
    state, _ = _state(s)
    assert all(t.dtype == F32 for t in state["patch_lufacs"])
    assert all(v.dtype == F64 for v in state["level_ops"][1:])
    assert all(t["lufac"].dtype == F64 for t in state["schoeberl"])
    assert state["coarse_fac"][0].dtype == F64


def test_store_f32_state_dtypes(mode_of):
    """Only the level-operator stream and the static patch parts narrow;
    the apply computes in f64 and matches the f64 apply to ~eps32."""
    mode_of("store32")
    s = _torch_solver(stabilisation_type="supg")
    s.solve(1)
    state, _ = _state(s)
    top = state["level_ops"][-1]
    assert isinstance(top, dict) and top["M"].dtype == F32
    assert all(t.dtype == F64 for t in state["patch_lufacs"])
    assert all(st["K"].dtype == F32 and st["G"].dtype == F32
               for st in s._almg_static["levels"])
    assert all(st["K"].dtype == F32 for st in s._almg_static["schoeberl"])
    mode_of("f64")
    s2 = _torch_solver(stabilisation_type="supg")
    s2.solve(1)
    state64, _ = _state(s2)
    L = s.vmg.nlevels - 1
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (s.vmg.levels[L].V.ndof, 2)))
    r32 = s.vmg.level_apply(L, top, v)
    r64 = s2.vmg.level_apply(L, state64["level_ops"][L], v)
    assert r32.dtype == F64
    assert _rel(r32, r64) < 1e-5


def test_f32_cycle_state_dtypes(mode_of, monkeypatch):
    """The f32 cycle casts the patch inverses and the level operators'
    gamma-free part, and stores the Schoeberl patches' f64 LU factors in
    f32 (kernel KL's state); the coarse factor stays f64;
    ALFI_TORCH_MG_F64_KEYS names what stays (``schoeberl``: the explicit
    f64 inverses)."""
    mode_of("cycle32")
    s = _torch_solver(4)
    state, _ = _state(s)
    assert all(t.dtype == F32 for t in state["patch_lufacs"])
    assert all(v["M"].dtype == F32 for v in state["level_ops"][1:])
    assert all("lufac" not in t and t["lu"]["lut"].dtype == F32
               for t in state["schoeberl"])
    assert state["coarse_fac"][0].dtype == F64
    monkeypatch.setenv("ALFI_TORCH_MG_F64_KEYS", "patch_lufacs,tensors")
    state, _ = _state(s)
    assert all(t.dtype == F64 for t in state["patch_lufacs"])
    assert all(v["M"].dtype == F64 for v in state["level_ops"][1:])
    assert all(t["lu"]["lut"].dtype == F32 for t in state["schoeberl"])
    monkeypatch.setenv("ALFI_TORCH_MG_F64_KEYS", "schoeberl")
    state, _ = _state(s)
    assert all("lu" not in t and t["lufac"].dtype == F64
               for t in state["schoeberl"])
    # and the cycle still maps f64 to f64 through f32
    rv = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (s.Z.V.ndof, 2))) * s.bcset.mask[0]
    out = s.vmg.make_solve_A(state)(rv)
    assert out.dtype == F64 and bool(torch.isfinite(out).all())


# ----------------------------------------------------------------------
# the gamma-split apply (test_mixed_cycle.py:49-180)
# ----------------------------------------------------------------------
def test_gamma_split_apply_matches_f64(mode_of):
    mode_of("cycle32")
    s = _torch_solver()
    s.advect_val = 1.0
    s.nu_val = s.char_L * s.char_U / 100.0
    state, params = _state(s)
    vmg = s.vmg
    L = vmg.nlevels - 1
    tens = state["level_ops"][L]
    assert isinstance(tens, dict), "f32 cycle must store gamma-split"
    assert tens["M"].dtype == F32
    v = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (vmg.levels[L].V.ndof, 2)))
    y64 = vmg.level_apply(L, _full_f64(s, L, params, s.z[0]), v)
    y32 = vmg.level_apply(L, tens, v.to(F32))
    assert y32.dtype == F32
    assert _rel(y32, y64) < 1e-5


def test_gamma_split_preserves_cancellation(mode_of):
    """On a discretely divergence-free field the grad-div term vanishes in
    the f32 apply too; the all-f32 summed apply rounds it at
    gamma * eps32."""
    mode_of("cycle32")
    s = _torch_solver()
    state, params = _state(s)
    vmg = s.vmg
    L = vmg.nlevels - 1
    lev = vmg.levels[L]
    tens = state["level_ops"][L]
    B = vmg.gd_factors(L).numpy()[:, :, 0]
    rows = lev.rows.numpy()
    rng = np.random.default_rng(5)
    nflat = lev.V.ndof * 2
    nc = B.shape[0]
    mflat = lev.mask_flat.numpy()
    C = np.zeros((nc, nflat))
    np.add.at(C, (np.repeat(np.arange(nc), rows.shape[1]), rows.ravel()),
              B.ravel())
    C = C * mflat[None, :]
    vf = rng.standard_normal(nflat) * mflat
    lam = np.linalg.lstsq(C @ C.T, C @ vf, rcond=None)[0]
    vf = vf - C.T @ lam
    d = (B * vf[rows]).sum(axis=1)
    assert np.max(np.abs(d)) < 1e-8 * np.linalg.norm(vf)
    v32 = torch.as_tensor(vf.reshape(lev.V.ndof, 2)).to(F32)
    v64 = v32.to(F64)
    full = _full_f64(s, L, params)
    y64 = vmg.level_apply(L, full, v64)
    y32 = vmg.level_apply(L, tens, v32)
    ysum32 = vmg.level_apply(L, full.to(F32), v32)
    err_split = _rel(y32, y64)
    err_sum = _rel(ysum32, y64)
    assert err_split < 3e-6
    assert err_sum > 30 * err_split


def test_gamma_split_with_jacobi_smoother(mode_of):
    """A Jacobi-smoothed f32 cycle stores the split too, and its diagonal
    is the f64 sum's (grad-div part included), cast."""
    from alfi_torch.graddiv import GradDivSolver

    params = {"nu": 1.0, "gamma": 1e4, "advect": 0.0}

    def build():
        gd = GradDivSolver(dim=2, baseN=4, nref=1, k=2, smoother="jacobi",
                           transfer=False, device="cpu")
        zero_u = torch.zeros((gd.form.V.ndof, 2), dtype=F64)
        return gd, gd.vmg.setup(zero_u, params, None, None)

    mode_of("cycle32")
    gd, state = build()
    L = gd.vmg.nlevels - 1
    tens = state["level_ops"][L]
    assert isinstance(tens, dict), "jacobi f32 cycle must store the split"
    assert tens["M"].dtype == F32
    mode_of("f64")
    gd64, state64 = build()
    assert torch.equal(state["patch_lufacs"][L - 1],
                       state64["patch_lufacs"][L - 1].to(F32))
    # the grad-div harness's f32 cycle converges within the JAX gate of
    # the f64 one's count, at a gamma where the Jacobi cycle converges
    # (at 1e4 neither does in 200 CG iterations)
    _, its32, conv = gd.solve(1.0)
    _, its64, _ = gd64.solve(1.0)
    assert conv and its32 <= 1.10 * its64 + 1


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
def _solve_A_both(nu):
    """One make_solve_A application on a seeded vector through the port
    and the JAX package, each in the mode their switches are set to, at
    ldc2d baseN=4 nref=1 with a seeded wind (gamma = 1e4, advect 1)."""
    import jax.numpy as jnp

    from alfi_tpu import ConstantPressureSolver as JaxSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

    t = _torch_solver(4)
    j = JaxSolver(JaxLDC(4), **KW)
    rng = np.random.default_rng(1)
    w = 0.1 * rng.standard_normal((t.Z.V.ndof, 2))
    pt = {"nu": nu, "gamma": 1e4, "advect": 1.0}
    pj = {k: jnp.asarray(v) for k, v in pt.items()}
    st, _ = _state(t, torch.as_tensor(w), pt)
    sj = j.vmg.setup(jnp.asarray(w), pj, schoeberl_state=j.vmg.transfer_setup(
        pj, j._almg_static["schoeberl"]), static=j._almg_static)
    rv = rng.standard_normal((t.Z.V.ndof, 2)) * t.bcset.mask[0].numpy()
    yt = t.vmg.make_solve_A(st)(torch.as_tensor(rv))
    yj = j.vmg.make_solve_A(sj)(jnp.asarray(rv))
    assert yt.dtype == F64
    return yt.numpy(), np.asarray(yj)


@pytest.mark.parametrize("mode", ("f64",) + MODES)
def test_solve_A_matches_jax(mode_of, mode):
    """make_solve_A, both packages in ``mode``, at Re 1's viscosity
    (nu = 2): 1e-10 in f64, 1e-4 in the f32 modes."""
    mode_of(mode)
    yt, yj = _solve_A_both(2.0)
    assert _rel(yt, yj) < (1e-10 if mode == "f64" else 1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_solve_A_at_re_100_rounds_as_the_jax_package(mode_of, mode):
    """make_solve_A at Re 100's viscosity (nu = 0.02), where the packages'
    f32 modes differ by more than 1e-4 (dc32 1.2e-3, store32 1.5e-4,
    cycle32 1.8e-3): the cause is each package's own f32 rounding, which
    the smoother's FGMRES amplifies at this viscosity.  The f64 applies
    agree to 1e-8; wherever the two f32 applies differ past 1e-4, the JAX
    package's departs by more than 1e-4 from its own f64 apply; and the
    port's departs from its own f64 apply by at most 1.5 times as much
    as the JAX package's does."""
    mode_of("f64")
    t64, j64 = _solve_A_both(0.02)
    assert _rel(t64, j64) < 1e-8
    mode_of(mode)
    yt, yj = _solve_A_both(0.02)
    own_t, own_j, gap = _rel(yt, t64), _rel(yj, j64), _rel(yt, yj)
    assert gap < 1e-4 or own_j > 1e-4, (gap, own_t, own_j)
    assert own_t <= 1.5 * own_j, (gap, own_t, own_j)


def test_f32_schoeberl_inverses_carry_the_f32_cycles_error(mode_of,
                                                          monkeypatch):
    """The repair of the f32 Schoeberl solve: with both packages' keys
    empty (their default), make_solve_A at nu = 0.02 in the f32 cycle
    departs from the port's own f64 apply by at most 1.5 times what the
    JAX package's departs from its own, the port applying f32 LU factors
    by kernel KL's plain version as the JAX package does.  The explicit
    inverses rounded to f32, which the port applied before (and kept in
    f64 by default to avoid), departed 6.1e-2, 60 times the JAX package's
    9.7e-4."""
    mode_of("f64")
    t64, j64 = _solve_A_both(0.02)
    mode_of("cycle32")
    monkeypatch.setenv("ALFI_TPU_MG_F64_KEYS", "")
    monkeypatch.delenv("ALFI_TORCH_MG_F64_KEYS", raising=False)
    yt, yj = _solve_A_both(0.02)
    own_t, own_j = _rel(yt, t64), _rel(yj, j64)
    assert own_t <= 1.5 * own_j, (own_t, own_j)


def test_graddiv_term_matches_jax_dict_apply(mode_of):
    """KB's plain version against the grad-div part of the JAX package's
    gamma-split dict apply (M zero there), both from the same f64 factors,
    masked as the level apply masks: 1e-12."""
    import jax.numpy as jnp

    from alfi_tpu import ConstantPressureSolver as JaxSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

    t = _torch_solver(4)
    j = JaxSolver(JaxLDC(4), **KW)
    for l in (1, 0):
        lev = t.vmg.levels[l]
        n = lev.V.ndof * 2
        term = kernels.GradDivTerm(lev.rows.numpy(), n, keep=lev.mask_flat,
                                   device="cpu")
        B = t.vmg.gd_factors(l)
        v = np.random.default_rng(20 + l).standard_normal(n)
        keep = lev.keep
        vt = torch.as_tensor(v)
        out_t = term(B, 1e4, vt, torch.where(keep, 0.0, vt))
        nc, nld = lev.rows.shape
        out_j = j.vmg.level_apply(
            l, {"M": jnp.zeros((nc, nld, nld), dtype=jnp.float32),
                "B": jnp.asarray(B.numpy()), "gamma": jnp.asarray(1e4)},
            jnp.asarray(v.reshape(-1, 2)))
        assert _rel(out_t, np.asarray(out_j).reshape(-1)) < 1e-12
        # the raw operator (the Schoeberl transfer's): no mask
        raw = kernels.GradDivTerm(lev.rows.numpy(), n, device="cpu")
        want = t.vmg.schoeberl[0]._apply_gd(1e4, vt.reshape(-1, 2)) if (
            l == 1) else None
        if want is not None:
            assert _rel(raw(B, 1e4, vt), want.reshape(-1)) < 1e-12


def test_store_apply_matches_jax_and_its_own_values(mode_of):
    """mg_store: the port's apply (f32 merged values, f64 arithmetic, KB)
    equals the JAX package's dict apply of the same f32 values and the same
    f64 factors at 1e-12 (each merged value put in one cell tensor, the
    first the assembly map sums it from, the rest 0), and the f64 apply of
    those values plus the f64 grad-div term at 1e-12; the narrowed values
    hold no grad-div part (they are the f64 gamma-free sum's to f32
    rounding); the JAX package's own mg_store apply, which narrows each
    cell's tensor, agrees at 1e-5."""
    import jax.numpy as jnp

    from alfi_tpu import ConstantPressureSolver as JaxSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

    mode_of("store32")
    t = _torch_solver(4)
    j = JaxSolver(JaxLDC(4), **KW)
    rng = np.random.default_rng(30)
    w = 0.1 * rng.standard_normal((t.Z.V.ndof, 2))
    pt = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}
    pj = {k: jnp.asarray(v) for k, v in pt.items()}
    st, _ = _state(t, torch.as_tensor(w), pt)
    sj = j.vmg.setup(jnp.asarray(w), pj, schoeberl_state=j.vmg.transfer_setup(
        pj, j._almg_static["schoeberl"]), static=j._almg_static)
    L = t.vmg.nlevels - 1
    v = rng.standard_normal((t.Z.V.ndof, 2))
    vt = torch.as_tensor(v)
    ops = st["level_ops"][L]
    yt = t.vmg.level_apply(L, ops, vt)
    lev = t.vmg.levels[L]
    same = t.vmg.level_ops[L].plain(ops["M"].to(F64), vt.reshape(-1))
    same = kernels.GradDivTerm(lev.rows.numpy(), lev.V.ndof * 2,
                               keep=lev.mask_flat, device="cpu").plain(
        t.vmg.gd_factors(L), 1e4, vt.reshape(-1), same)
    assert _rel(yt.reshape(-1), same) < 1e-12
    # the same f32 values and f64 factors through the JAX dict apply
    pat = t.vmg.level_ops[L].pattern
    nc, nld = lev.rows.shape
    first = pat.amap_src[pat.amap_ptr[:-1][np.diff(pat.amap_ptr) > 0]]
    cells = np.zeros(nc * nld * nld, dtype=np.float32)
    cells[first] = ops["M"].numpy().reshape(-1)[np.diff(pat.amap_ptr) > 0]
    yd = j.vmg.level_apply(
        L, {"M": jnp.asarray(cells.reshape(nc, nld, nld)),
            "B": jnp.asarray(t.vmg.gd_factors(L).numpy()),
            "gamma": jnp.asarray(1e4)}, jnp.asarray(v))
    assert _rel(yt, yd) < 1e-12
    # no grad-div part in the narrowed values
    form = lev.form
    M64 = t.vmg.level_assemble(L, pt["nu"] * form._static_velocity_tensors()[0]
                               + form.advection_element_tensors(
                                   torch.as_tensor(w)))
    assert _rel(ops["M"], M64) < 1e-7
    yj = j.vmg.level_apply(L, sj["tensors"][L], jnp.asarray(v),
                           ftensors=sj["ftensors"][L])
    assert _rel(yt, yj) < 1e-5


def test_k1_f32_plain_matches_the_pallas_xla_form():
    """K1's plain version in f32 against the Pallas kernel's plain-XLA
    form, ``apply_transposed_xla`` (``git show aaee1ce^:alfi_tpu/solvers/
    patch_pallas.py``: out[i, p] = sum_j fac[i, j, p] r[j, p] over the
    patch-minor f32 inverses, summed in f32), on the smoother's patch
    table at ldc2d baseN=4 nref=1 level 1; the scatter of the patch
    results in f64 numpy: 1e-5."""
    import jax.numpy as jnp

    t = _torch_solver(4)
    ps = t.vmg.patchsets[0]
    op = kernels.GatherGemvScatter(ps.dofs, ps.nflat, "K1", device="cpu")
    nb, m, _ = op.ashape
    rng = np.random.default_rng(40)
    A = rng.standard_normal((nb, m, m)).astype(np.float32)
    r = rng.standard_normal(ps.nflat).astype(np.float32)
    out = op(torch.as_tensor(A), torch.as_tensor(r))
    assert out.dtype == F32
    dofs = np.asarray(ps.dofs)
    live = (dofs >= 0) & (dofs < ps.nflat)
    rp = np.where(live, r[np.where(live, dofs, 0)], 0.0).astype(
        np.float32).T  # (m, np)
    fac = jnp.asarray(np.transpose(A, (1, 2, 0)))  # (m, m, np)
    outp = np.asarray(jnp.sum(fac * jnp.asarray(rp)[None, :, :], axis=1),
                      dtype=np.float64)  # (m, np)
    want = np.zeros(ps.nflat)
    np.add.at(want, dofs.T[live.T], outp[live.T])
    assert _rel(out, want) < 1e-5


def test_fgmres_follows_the_vector_dtype():
    """FGMRES on f32 vectors: the iterate, the residual estimate and the
    rotations stay f32 (nothing promotes through an f64 scalar), and the
    fixed-iteration result matches the JAX package's f32 FGMRES at
    1e-5."""
    import jax.numpy as jnp

    from alfi_torch.solvers.krylov import fgmres
    from alfi_tpu.solvers.krylov import fgmres as jfgmres

    rng = np.random.default_rng(50)
    n = 40
    M = (np.eye(n) * 4 + rng.standard_normal((n, n)) / np.sqrt(n)).astype(
        np.float32)
    D = (1.0 + rng.random(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    Mt, Dt = torch.as_tensor(M), torch.as_tensor(D)
    x, info = fgmres(lambda v: (Mt * v[None, :]).sum(1), torch.as_tensor(b),
                     pc=lambda v: v / Dt, rtol=0.0, atol=-1.0, maxit=6,
                     restart=6)
    assert x.dtype == F32 and info["rnorm"].dtype == F32
    Mj, Dj = jnp.asarray(M), jnp.asarray(D)
    xj, _ = jfgmres(lambda v: (Mj * v[None, :]).sum(1), jnp.asarray(b),
                    pc=lambda v: v / Dj, rtol=0.0, atol=-1.0, maxit=6,
                    restart=6)
    assert xj.dtype == jnp.float32
    assert _rel(x, xj) < 1e-5
    # converging mode: the same in f32
    x, info = fgmres(lambda v: (Mt * v[None, :]).sum(1), torch.as_tensor(b),
                     rtol=1e-5, atol=0.0, maxit=50, restart=10)
    assert x.dtype == F32 and info["converged"]
    # and Chebyshev (the grad-div harness's smoother) against the JAX one
    from alfi_torch.solvers.krylov import chebyshev
    from alfi_tpu.solvers.krylov import chebyshev as jchebyshev

    y = chebyshev(lambda v: (Mt * v[None, :]).sum(1), torch.as_tensor(b),
                  lambda v: v / Dt, maxit=4, lmax=5.0)
    yj = jchebyshev(lambda v: (Mj * v[None, :]).sum(1), jnp.asarray(b),
                    lambda v: v / Dj, maxit=4, lmax=5.0)
    assert y.dtype == F32 and yj.dtype == jnp.float32
    assert _rel(y, yj) < 1e-5


def test_transfers_follow_the_vector_dtype():
    """Prolongation, restriction and the Schoeberl transfer map f32 to f32
    (the JAX package casts the weights to the vector's dtype) and agree
    with f64 to f32 accuracy."""
    s = _torch_solver(4)
    params = s.params()
    ts = s._transfer_setup(params)
    vmg = s.vmg
    rng = np.random.default_rng(60)
    xc = torch.as_tensor(rng.standard_normal((vmg.levels[0].V.ndof, 2)))
    rf = torch.as_tensor(rng.standard_normal((vmg.levels[1].V.ndof, 2)))
    state = {"schoeberl": ts}
    for fn, x in ((vmg._prolong, xc), (vmg._restrict, rf)):
        y64 = fn(0, state, x)
        y32 = fn(0, state, x.to(F32))
        assert y32.dtype == F32
        assert _rel(y32, y64) < 1e-5
    # the standard transfers alone
    p = vmg.prolongs[0]
    assert p.apply(xc.to(F32)).dtype == F32
    assert p.apply_transpose(rf.to(F32)).dtype == F32


def test_kernel_wrappers_take_the_mode_dtypes():
    """The wrappers accept f64 and f32 where their kernels do, refuse a
    mixed K1 call, and count no launch on the CPU."""
    s = _torch_solver(4)
    vmg = s.vmg
    op = vmg.level_ops[1]
    vals = vmg.level_assemble(1, torch.as_tensor(np.random.default_rng(70)
                                                 .standard_normal(
                                                     op.cell_shape)))
    x = torch.as_tensor(np.random.default_rng(71).standard_normal(op.n))
    y = op(vals, x)
    for vt, xt, tol in ((F64, F32, 1e-12), (F32, F64, 1e-12),
                        (F32, F32, 1e-6)):
        out = op(vals.to(vt), x.to(xt))
        assert out.dtype == xt
        # f64 arithmetic where either is f64 (the JAX promotion), f32 else
        want = op.plain(vals.to(vt).to(F64), x.to(xt).to(F64))
        assert _rel(out.to(F64), want.to(xt).to(F64)) < tol
        assert _rel(out, y) < 1e-5
    table = vmg.patch_solvers[0][1]
    A = torch.ones(table.ashape, dtype=F32)
    with pytest.raises(ValueError, match="float32"):
        table(A, x, x)
    assert table.a_bytes(itemsize=4)[1] * 2 == table.a_bytes()[1]
    assert op.value_bytes(4) < op.value_bytes()
    kernels.reset_launch_counts()
    term = kernels.GradDivTerm(vmg.levels[1].rows.numpy(), op.n,
                               keep=vmg.levels[1].mask_flat, device="cpu")
    out = term(vmg.gd_factors(1), 1e4, x.to(F32))
    assert out.dtype == F32
    assert kernels.GradDivTerm.launches["KB"] == 0 and term.launched == 0
    with pytest.raises(ValueError):
        term(vmg.gd_factors(1)[:-1], 1e4, x)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4225, 14), (2048, 6), (300, 189),
                                   (125, 1590), (2000, 27)])
def test_cuda_k1_f32_matches_plain(shape):
    """K1 in f32 against its plain f32 version, bare and masked, through
    every kernel that takes the table: 1e-5 relative (f32 sums in another
    order), two launches bitwise equal, one launch counted per call."""
    dev = _cuda()
    nb, m = shape
    n = nb * m // 3
    rng = np.random.default_rng(0)
    idx = rng.integers(0, n + 1, size=(nb, m))
    mask = (rng.random(n) < 0.8).astype(float)
    A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev,
                        dtype=F32)
    x = torch.as_tensor(rng.standard_normal(n), device=dev, dtype=F32)
    p = torch.as_tensor(rng.standard_normal(n), device=dev, dtype=F32)
    paths = (0, 1, 2) if m % 2 == 0 and m <= kernels.PAIR_MAX_M else (0,)
    for masks, args in (({}, ()), ({"out_mask": mask}, (p,))):
        op = kernels.GatherGemvScatter(idx, n, "K1", device=dev, **masks)
        yp = op.plain(A, x, *args)
        for path in paths:
            op.path = path
            before, f32_before = op.launched, op.f32_launched
            yk, yk2 = op(A, x, *args), op(A, x, *args)
            torch.cuda.synchronize()
            assert op.launched == before + 2
            assert op.f32_launched == f32_before + 2
            assert yk.dtype == F32 and torch.equal(yk, yk2)
            assert float((yk - yp).abs().max() / yp.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("baseN, k, dim", [(4, 2, 2), (2, 2, 3)])
def test_cuda_km_modes_match_plain(baseN, k, dim):
    """KM in its three mixed modes against its plain version on the
    merged patterns of small hierarchies: f64 arithmetic where the values
    or the vectors are f64, so 1e-12 with f64 out and one f32 rounding
    (1e-6) with f32 out; 1e-5 in (f32, f32); bitwise repeatable."""
    from alfi_torch.problems import ThreeDimLidDrivenCavityProblem

    dev = _cuda()
    prob = TorchLDC(baseN) if dim == 2 else ThreeDimLidDrivenCavityProblem(
        baseN)
    s = TorchSolver(prob, device="cpu", **dict(KW, k=k))
    rng = np.random.default_rng(80)
    for host in s.vmg.level_ops[1:]:
        op = kernels.MergedLevelOperator(host.pattern, device=dev)
        vals = torch.as_tensor(rng.standard_normal(op.vshape), device=dev)
        x = torch.as_tensor(rng.standard_normal(op.n), device=dev)
        for vt, xt, tol in ((F64, F32, 1e-6), (F32, F64, 1e-12),
                            (F32, F32, 1e-5)):
            v, xx = vals.to(vt), x.to(xt)
            mode = "%s/%s" % tuple("f32" if t == F32 else "f64"
                                   for t in (vt, xt))
            before = op.mode_launched[mode]
            y1, y2 = op(v, xx), op(v, xx)
            yp = op.plain(v, xx)
            torch.cuda.synchronize()
            assert op.mode_launched[mode] == before + 2
            assert y1.dtype == xt and torch.equal(y1, y2)
            assert float((y1 - yp).abs().max() / yp.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("baseN, nref, dim", [(4, 2, 2), (2, 1, 3)])
def test_cuda_graddiv_term_matches_plain(baseN, nref, dim):
    """KB against its plain version at every applied level of a small 2D
    and a small 3D hierarchy, with the level's mask (the level operators')
    and raw (the Schoeberl transfers'), on f64 and f32 vectors, in place on
    y and out of place: 1e-13 (f64 arithmetic both; f32 out rounds once);
    bitwise repeatable; one launch counted per call, on the table's f32
    count too for f32 vectors."""
    from alfi_torch.problems import ThreeDimLidDrivenCavityProblem

    dev = _cuda()
    prob = TorchLDC(baseN) if dim == 2 else ThreeDimLidDrivenCavityProblem(
        baseN)
    s = TorchSolver(prob, device="cpu", **dict(KW, nref=nref))
    rng = np.random.default_rng(90)
    for l in range(1, s.vmg.nlevels):
        lev = s.vmg.levels[l]
        n = lev.V.ndof * dim
        B = s.vmg.gd_factors(l).to(dev)
        for keep in (lev.mask_flat, None):
            term = kernels.GradDivTerm(lev.rows.numpy(), n, keep=keep,
                                       device=dev)
            for dt in (F64, F32):
                x = torch.as_tensor(rng.standard_normal(n), device=dev,
                                    dtype=dt)
                y = torch.as_tensor(rng.standard_normal(n), device=dev,
                                    dtype=dt)
                yp = term.plain(B, 1e4, x, y)
                before = kernels.GradDivTerm.launches["KB"]
                f32_before = term.f32_launched
                o1, o2 = term(B, 1e4, x, y), term(B, 1e4, x, y)
                torch.cuda.synchronize()
                assert kernels.GradDivTerm.launches["KB"] == before + 2
                assert term.f32_launched == f32_before + 2 * (dt == F32)
                assert o1.dtype == dt and torch.equal(o1, o2)
                tol = 1e-13 if dt == F64 else 1e-6
                assert float((o1 - yp).abs().max()
                             / yp.abs().max()) <= tol
                y2 = y.clone()
                term(B, 1e4, x, y2, out=y2)
                assert torch.equal(y2, o1)
