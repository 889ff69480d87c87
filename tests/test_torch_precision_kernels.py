"""The precision path's kernels of the eleventh slice, on the CPU against
the JAX package and against their own earlier forms, and on a card
against their plain versions:

* KL, the gathered batched LU solve (``kernels.PatchLUSolve``): its plain
  version on the f32 LU factors of the Schoeberl transfer's patch matrices
  (ldc2d baseN=4 nref=1, nu = 0.02, gamma = 1e4) against the JAX
  package's ``jax.scipy.linalg.lu_solve`` on the same f32 factors, and
  against a numpy emulation of the kernel's reading rule (the gather with
  the row interchanges folded in, the column-major factors, forward and
  back substitution column by column, the plain store and the zeros
  outside the patches); on overlapping patches with an out-mask (the
  Chebyshev smoother's) against the explicit f64 inverses of K1;
* the strided K1 kernel's lanes per dof for f32 A, a rule of their own;
* KB's split form, the cell stage with KM's epilogue: the same bits as
  the apply it replaces (KM, then KB's dof stage on KM's output) in
  store32 and in the f32 cycle, one f32 rounding apart with f64 values on
  f32 vectors, where y is no longer rounded before the sum;
* the grad-div study with the smoother stored in f32
  (``mg_smooth_dtype`` f32 under the Chebyshev driver): one
  ``gamma_sweep`` row, patch + transfer, the JAX package's counts at all
  eight gamma.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import config as tconfig
from alfi_torch import kernels
from alfi_torch.mg.patches import static_patch_sum
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _schoeberl_lu(baseN=4, nu=0.02):
    """The Schoeberl transfer's KL table of ldc2d baseN nref=1, its f64
    patch matrices at (nu, gamma = 1e4), their KL state and a seeded
    vector."""
    s = TorchSolver(TorchLDC(baseN), device="cpu", **KW)
    t = s.vmg.schoeberl[0]
    A = static_patch_sum(s._almg_static["schoeberl"][0],
                         {"nu": nu, "gamma": 1e4})
    table = kernels.PatchLUSolve(t.patchset.dofs, t.patchset.nflat,
                                 device="cpu")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(table.n))
    return table, A, table.factor(A), x


def test_kl_plain_matches_jax_lu_solve():
    """KL's plain version against jax.scipy.linalg.lu_solve on the same
    f32 factors (pivots 0-based there), scattered by the same table: 1e-5
    relative (two f32 triangular solves, the sums in other orders)."""
    import jax.numpy as jnp
    from jax.scipy.linalg import lu_solve

    table, _, fac, x = _schoeberl_lu()
    assert table.disjoint and fac["lut"].dtype == F32
    x32 = x.to(F32)
    mine = table(fac, x32)
    assert mine.dtype == F32
    lu32 = fac["lut"].mT.numpy()
    b = table.gathered(x32).numpy()
    y = np.asarray(lu_solve((jnp.asarray(lu32),
                             jnp.asarray(fac["piv"].numpy() - 1)),
                            jnp.asarray(b)[..., None]))[..., 0]
    want = np.zeros(table.n + 1, dtype=np.float32)
    want[table.pidx.numpy().reshape(-1)] = y.reshape(-1)
    assert _rel(mine.numpy(), want[:table.n]) < 1e-5


def test_kl_plain_matches_its_reading_rule():
    """A numpy emulation of what the kernel reads and computes (gperm,
    the column-major factors, forward and back substitution column by
    column in f32, the plain store, 0 outside the patches) against the
    plain version: 1e-5 relative; the dofs outside every patch are 0."""
    table, _, fac, x = _schoeberl_lu()
    x32 = x.to(F32).numpy()
    lut = fac["lut"].numpy()
    gperm = fac["gperm"].numpy()
    sidx = table.sidx.numpy()
    nb, m = gperm.shape
    out = np.full(table.n, np.nan, dtype=np.float32)
    out[table.zero.numpy()] = 0.0
    for p in range(nb):
        b = np.where(gperm[p] >= 0, x32[np.maximum(gperm[p], 0)],
                     0.0).astype(np.float32)
        for j in range(m):
            b[j + 1:] -= lut[p, j, j + 1:] * b[j]
        for j in range(m - 1, -1, -1):
            b[j] = b[j] / lut[p, j, j]
            b[:j] -= lut[p, j, :j] * b[j]
        live = sidx[p] >= 0
        out[sidx[p][live]] = b[live]
    assert not np.isnan(out).any()
    mine = table(fac, x.to(F32)).numpy()
    assert _rel(out, mine) < 1e-5
    assert np.all(mine[table.zero.numpy()] == 0.0)


def test_kl_overlapping_patches_match_the_inverses():
    """On the smoother's overlapping star patches with the level's BC mask
    out: f64 factors through KL's plain version against K1's plain version
    on the explicit f64 inverses of the same matrices, 1e-9; f32 factors on
    f64 vectors (x rounded to f32, an f32 solve, the rows summed in f64)
    within 1e-5 of that."""
    s = TorchSolver(TorchLDC(4), device="cpu", **KW)
    vmg = s.vmg
    ps = vmg.patchsets[0]
    lev = vmg.levels[1]
    rng = np.random.default_rng(5)
    T = torch.as_tensor(rng.standard_normal(
        (lev.rows.shape[0],) + (lev.rows.shape[1],) * 2))
    T = T @ T.mT + 30.0 * torch.eye(T.shape[-1], dtype=F64)
    A = vmg.patch_solvers[0][0](T, invert=False)
    table = kernels.PatchLUSolve(ps.dofs, ps.nflat, out_mask=lev.mask_flat,
                                 device="cpu")
    assert not table.disjoint
    x = torch.as_tensor(rng.standard_normal(table.n))
    want = vmg.patch_solvers[0][1].plain(torch.linalg.inv(A), x, x)
    assert _rel(table(table.factor(A, F64), x, x), want) < 1e-9
    y32 = table(table.factor(A), x, x)
    assert y32.dtype == F64 and _rel(y32, want) < 1e-5


@pytest.mark.parametrize("extent, f64_lanes, f32_lanes", [
    (6, 4, 4), (27, 4, 4), (129, 32, 8), (189, 32, 8), (1590, 32, 32)])
def test_strided_lanes_follow_the_dtype(extent, f64_lanes, f32_lanes):
    """The strided K1 kernel's lanes per dof: the f64 rule (two batches of
    4 steps of the 75 % row) unchanged; f32 A (four batches of 8 steps) a
    quarter of f64's lanes on the 3D star rows (129-189 columns), the
    same on the short Schoeberl rows and the 1,590-column macrostar
    rows; the wrapper keeps both per table."""
    rows = np.full(50, extent)
    assert 1 << kernels.strided_lanes_log2(rows) == f64_lanes
    assert 1 << kernels.strided_lanes_log2(rows, itemsize=4) == f32_lanes
    op = kernels.GatherGemvScatter(np.arange(2 * extent).reshape(2, extent),
                                   2 * extent, "K1", device="cpu")
    assert (1 << op.lanes_log2, 1 << op.lanes_log2_f32) == (f64_lanes,
                                                           f32_lanes)


@pytest.mark.parametrize("vt, xt", [(F32, F64), (F32, F32), (F64, F32)])
def test_split_apply_rounds_as_before(vt, xt):
    """The split level apply, KB's cell stage then KM with KB's dof stage
    as its epilogue, against the apply it replaces (KM, then KB on KM's
    output): equal bits where the promoted sum is already in the vectors'
    dtype (store32: f32 values on f64 vectors; the f32 cycle: f32 on f32);
    with f64 values on f32 vectors, y is no longer rounded to f32 before
    the grad-div sum is added, so the two are one f32 rounding apart."""
    s = TorchSolver(TorchLDC(4), device="cpu", **KW)
    vmg = s.vmg
    rng = np.random.default_rng(11)
    for l in range(1, vmg.nlevels):
        op = vmg.level_ops[l]
        lev = vmg.levels[l]
        term = kernels.GradDivTerm(lev.rows.numpy(), op.n,
                                   keep=lev.mask_flat, device="cpu")
        B = vmg.gd_factors(l)
        vals = torch.as_tensor(rng.standard_normal(op.vshape)).to(vt)
        x = torch.as_tensor(rng.standard_normal(op.n)).to(xt)
        old = term(B, 1e4, x, op(vals, x))
        new = op(vals, x, graddiv=(term, term.cell_stage(B, 1e4, x)))
        assert new.dtype == xt
        if vt == F64 and xt == F32:
            assert _rel(new, old) < 2 ** -23
        else:
            assert torch.equal(new, old)


def _set_smooth(dtype):
    import jax.numpy as jnp

    from alfi_tpu import config as jconfig

    tconfig.set_mg_smooth_dtype(dtype)
    jconfig.set_mg_smooth_dtype(jnp.float32 if dtype == F32 else jnp.float64)


def test_f32_stored_chebyshev_smoother_matches_jax():
    """ROADMAP Queue 3 (b): the grad-div study's patch + transfer row with
    the smoother's patch factors stored in f32 (mg_smooth_dtype f32 under
    the Chebyshev driver; the JAX package's f32 LU factors, the port's
    through kernel KL on f64 vectors) takes the JAX package's CG counts at
    all eight gamma, 1e8 included."""
    from alfi_torch.graddiv import gamma_sweep as torch_sweep
    from alfi_tpu.graddiv import gamma_sweep as jax_sweep

    kw = dict(baseN=4, nref=1, k=2, smoothing=3, smoother="patch",
              transfer=True)
    _set_smooth(F32)
    try:
        tc = torch_sweep(device="cpu", **kw)
        jc = jax_sweep(**kw)
    finally:
        _set_smooth(F64)
    assert tc == jc, (tc, jc)
    assert max(tc.values()) < 201


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("baseN", [4, 16])
def test_cuda_kl_matches_plain(baseN):
    """KL on the card against its plain version, both on the same f32
    factors of the Schoeberl patches (baseN nref=1, nu = 0.02): 1e-4
    relative (f32 triangular solves in other orders), two launches bitwise
    equal, the dofs outside the patches 0, one launch counted per call;
    and on the smoother's overlapping patches with f32 factors on f64
    vectors (an f32 solve, the rows summed in f64; two launches a call),
    1e-5."""
    dev = _cuda()
    table, A, _, x = _schoeberl_lu(baseN)
    ct = kernels.PatchLUSolve(table.pidx.numpy(), table.n, device=dev)
    fac = ct.factor(A.to(dev))
    x32 = x.to(dev, F32)
    before = ct.launched
    y1, y2 = ct(fac, x32), ct(fac, x32)
    yp = ct.plain(fac, x32)
    torch.cuda.synchronize()
    assert ct.launched == before + 2 and torch.equal(y1, y2)
    assert _rel(y1.cpu(), yp.cpu()) < 1e-4
    assert bool((y1[ct.zero.long()] == 0).all())
    s = TorchSolver(TorchLDC(baseN), device="cpu", **KW)
    ps, lev = s.vmg.patchsets[0], s.vmg.levels[1]
    rng = np.random.default_rng(7)
    T = torch.as_tensor(rng.standard_normal(
        (lev.rows.shape[0],) + (lev.rows.shape[1],) * 2))
    T = T @ T.mT + 30.0 * torch.eye(T.shape[-1], dtype=F64)
    A = s.vmg.patch_solvers[0][0](T, invert=False).to(dev)
    ot = kernels.PatchLUSolve(ps.dofs, ps.nflat, out_mask=lev.mask_flat,
                              device=dev)
    fac = ot.factor(A)
    x = torch.as_tensor(rng.standard_normal(ot.n), device=dev)
    before = ot.mixed_launched
    y1, y2 = ot(fac, x, x), ot(fac, x, x)
    yp = ot.plain(fac, x, x)
    torch.cuda.synchronize()
    assert ot.mixed_launched == before + 2 and torch.equal(y1, y2)
    assert y1.dtype == F64 and _rel(y1.cpu(), yp.cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("baseN, nref, dim", [(4, 2, 2), (2, 1, 3)])
def test_cuda_split_apply_matches_plain(baseN, nref, dim):
    """The split level apply on the card, KB's cell stage (its new lanes
    per cell) then KM with the grad-div epilogue, against the plain
    versions at every applied level of a small 2D and 3D hierarchy, in the
    three mixed modes: the cell stage's contributions within 1e-13, the
    apply within 1e-12 with f64 vectors and 1e-6 with f32 ones;
    bitwise repeatable; one KB and one KM launch counted per apply, the
    KM one as an epilogue launch."""
    from alfi_torch.problems import ThreeDimLidDrivenCavityProblem

    dev = _cuda()
    prob = TorchLDC(baseN) if dim == 2 else ThreeDimLidDrivenCavityProblem(
        baseN)
    s = TorchSolver(prob, device="cpu", **dict(KW, nref=nref))
    rng = np.random.default_rng(95)
    for l in range(1, s.vmg.nlevels):
        host = s.vmg.level_ops[l]
        lev = s.vmg.levels[l]
        op = kernels.MergedLevelOperator(host.pattern, device=dev)
        term = kernels.GradDivTerm(lev.rows.numpy(), op.n,
                                   keep=lev.mask_flat, device=dev)
        B = s.vmg.gd_factors(l).to(dev)
        vals = torch.as_tensor(rng.standard_normal(op.vshape), device=dev)
        x = torch.as_tensor(rng.standard_normal(op.n), device=dev)
        for vt, xt, tol in ((F32, F64, 1e-12), (F32, F32, 1e-6),
                            (F64, F32, 1e-6)):
            v, xx = vals.to(vt), x.to(xt)
            mode = "%s/%s" % tuple("f32" if t == F32 else "f64"
                                   for t in (vt, xt))
            kb, gd = term.launched, op.gd_launched[mode]
            w = term.cell_stage(B, 1e4, xx)
            want = term.contributions(B, term._plain_cells(B, 1e4, xx))
            assert _rel(w.cpu(), want.cpu()) < 1e-13
            y1 = op(v, xx, graddiv=(term, w))
            y2 = op(v, xx, graddiv=(term, term.cell_stage(B, 1e4, xx)))
            yp = op.plain(v, xx, graddiv=(term, w))
            torch.cuda.synchronize()
            assert term.launched == kb + 2
            assert op.gd_launched[mode] == gd + 2
            assert y1.dtype == xt and torch.equal(y1, y2)
            assert _rel(y1.cpu(), yp.cpu()) <= tol
