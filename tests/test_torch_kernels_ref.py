"""The fused gather-GEMV-scatter's plain version against the JAX package
and a numpy reference, and the CUDA kernel against its plain version (on a
card only).

* the level operator: alfi_torch VelocityMG.level_apply on the merged
  operator (plain path on the CPU) vs alfi_tpu VelocityMG.level_apply,
  normwise relative 1e-12 (summation order only).
* K1, the patch apply: explicit f64 inverses (the port) vs the JAX CPU
  path's LU solves, on the gamma=1e4 patch operators whose condition
  numbers reach ~1e8 (docs/DESIGN.md:34-44): normwise relative 1e-7.

The JAX package is imported inside the fixtures, so that the CUDA tests
also run on a GPU host without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_ref.py``.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import kernels
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solvers():
    from alfi_tpu import ConstantPressureSolver as JaxSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

    torch.set_num_threads(1)
    return (TorchSolver(TorchLDC(4), device="cpu", **KW),
            JaxSolver(JaxLDC(4), **KW))


@pytest.fixture(scope="module")
def jnp():
    import jax.numpy

    return jax.numpy


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _wind(solver, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((solver.Z.V.ndof, 2))


def test_level_apply_matches_jax(solvers, jnp):
    t, j = solvers
    rng = np.random.default_rng(11)
    lev = t.vmg.levels[1]
    nc, nld = lev.rows.shape
    T = rng.standard_normal((nc, nld, nld))
    v = rng.standard_normal((lev.V.ndof, 2))
    out_t = t.vmg.level_apply(1, t.vmg.level_assemble(1, torch.as_tensor(T)),
                              torch.as_tensor(v))
    out_j = j.vmg.level_apply(1, jnp.asarray(T), jnp.asarray(v))
    assert _rel(out_t, out_j) < 1e-12


@pytest.mark.parametrize("kind", ["smoother", "schoeberl"])
def test_patch_apply_matches_jax(solvers, jnp, kind):
    """The fused K1 call (masks folded in) against the JAX patch apply
    with the masks its callers put around it."""
    t, j = solvers
    w = _wind(t, 3)
    tform, jform = t.vmg.levels[1].form, j.vmg.levels[1].form
    r = np.random.default_rng(5).standard_normal(
        t.vmg.levels[1].V.ndof * 2)
    if kind == "smoother":
        (tfac, tapply), (jfac, japply) = (t.vmg.patch_solvers[0],
                                          j.vmg.patch_solvers[0])
        Tt = tform.velocity_element_tensors(PARAMS, torch.as_tensor(w))
        Tj = jform.velocity_element_tensors(PARAMS, jnp.asarray(w))
        mask = np.asarray(j.vmg.levels[1].mask_flat)
        out_t = tapply(tfac(Tt), torch.as_tensor(r), torch.as_tensor(r))
        out_j = (mask * np.asarray(japply(jfac(Tj), jnp.asarray(mask * r)))
                 + (1.0 - mask) * r)
    else:
        ts, js = t.vmg.schoeberl[0], j.vmg.schoeberl[0]
        tfac, tapply, jfac, japply = ts.factor, ts.papply, js.factor, \
            js.papply
        p0 = dict(PARAMS, advect=0.0)
        Tt = tform.velocity_element_tensors(p0, torch.as_tensor(w))
        Tj = jform.velocity_element_tensors(p0, jnp.asarray(w))
        zmask = np.asarray(js.zmask).reshape(-1)
        out_t = tapply(tfac(Tt), torch.as_tensor(r))
        out_j = japply(jfac(Tj), jnp.asarray(zmask * r))
    assert _rel(out_t, out_j) < 1e-7


@pytest.mark.parametrize("kind", ["smoother", "schoeberl"])
def test_patch_tables_hold_no_masked_dof(solvers, kind):
    """K1 needs no in-mask: a PatchSet drops every dof its mask zeroes,
    so the main path binds none (the smoother binds only its out-mask)."""
    t = solvers[0]
    if kind == "smoother":
        ps, op = t.vmg.patchsets[0], t.vmg.patch_solvers[0][1]
        mask = t.vmg.levels[1].mask_flat.numpy()
        assert op.out_keep is not None
    else:
        ts = t.vmg.schoeberl[0]
        ps, op, mask = ts.patchset, ts.papply, ts.zmask.numpy().reshape(-1)
        assert op.out_keep is None
    assert op.in_keep is None
    real = ps.dofs[ps.dofs < ps.nflat]
    assert (mask == 0).any() and np.all(mask[real] == 1)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("masked, nbytes", [(False, 128), (True, 110)])
def test_bound_counts_what_the_function_needs(masked, nbytes):
    """chip_smoke's bound on a table small enough to count by hand:
    idx [[0, 1], [1, 2]], n = 3, with the mask [1, 1, 0] in and out or
    none.  Bare: 8 A entries, the 4 indices, x at 3 dofs, 3 outputs =
    64 + 16 + 24 + 24 B.  Masked: the A entries of rows owned by dofs 0,
    1 and columns gathering dofs 0, 1 (5), the indices, x at 2 dofs, the
    out, the in-mask (it zeroes idx 2) and out-mask, passthrough at dof 2
    = 40 + 16 + 16 + 24 + 3 + 3 + 8 B."""
    cs = _chip_smoke()
    mask = np.array([1.0, 1.0, 0.0]) if masked else None
    op = kernels.GatherGemvScatter(np.array([[0, 1], [1, 2]]), 3, "K2",
                                   in_mask=mask, out_mask=mask, device="cpu")
    ms, by = cs._bound(op)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / cs.HBM_BYTES_PER_S,
                               rel=1e-12)


@pytest.mark.parametrize("masked, nbytes", [(False, 248), (True, 218)])
def test_bound_on_an_odd_m_table(masked, nbytes):
    """The same count at an odd m (A is dense, no padded leading
    dimension): idx [[0, 1, 2], [2, 3, 4]], n = 5, mask [1, 1, 1, 1, 0].
    Bare: 18 A entries, 6 indices, x at 5 dofs, 5 outputs = 144 + 24 + 40
    + 40 B.  Masked: block 0 keeps its 3 rows x 3 columns, block 1 the
    rows of dofs 2, 3 and the columns of dofs 2, 3 (13 entries), the
    indices, the out, x at 4 dofs, the in-mask and out-mask, passthrough
    at dof 4 = 104 + 24 + 40 + 32 + 5 + 5 + 8 B."""
    cs = _chip_smoke()
    mask = np.array([1.0, 1.0, 1.0, 1.0, 0.0]) if masked else None
    op = kernels.GatherGemvScatter(np.array([[0, 1, 2], [2, 3, 4]]), 5, "K1",
                                   in_mask=mask, out_mask=mask, device="cpu")
    ms, by = cs._bound(op)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / cs.HBM_BYTES_PER_S,
                               rel=1e-12)


def _table(rng, nb, m, n):
    """Random (nb, m) index table into [0, n) with pads on both sides."""
    return rng.integers(-3, n + 3, size=(nb, m))


def _reference(A, x, idx, n, in_mask=None, out_mask=None, p=None):
    """out_mask * sum_b S_b^T A_b S_b (in_mask * x) + (1 - out_mask) * p
    in numpy: einsum, then np.add.at (index_add) over the real entries."""
    xin = x if in_mask is None else in_mask * x
    real = (idx >= 0) & (idx < n)
    xg = np.where(real, xin[np.clip(idx, 0, n - 1)], 0.0)
    Y = np.einsum("bij,bj->bi", A, xg)
    acc = np.zeros(n)
    np.add.at(acc, idx[real], Y[real])
    return acc if out_mask is None else out_mask * acc + (1 - out_mask) * p


def test_plain_version_reads_pads_as_zero():
    """The gather half of the fused op's plain version: an index entry
    outside [0, n) reads 0 and owns no output."""
    rng = np.random.default_rng(0)
    nb, m, n = 7, 5, 20
    A = rng.standard_normal((nb, m, m))
    x = rng.standard_normal(n)
    idx = _table(rng, nb, m, n)
    op = kernels.GatherGemvScatter(idx, n, "K1", device="cpu")
    out = op(torch.as_tensor(A), torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), _reference(A, x, idx, n),
                               rtol=1e-14, atol=1e-14)
    # x at a pad-only dof does not matter
    hit = np.zeros(n, bool)
    hit[idx[(idx >= 0) & (idx < n)]] = True
    x2 = np.where(hit, x, 1e300)
    out2 = op(torch.as_tensor(A), torch.as_tensor(x2))
    np.testing.assert_array_equal(out2.numpy(), out.numpy())


def test_plain_version_scatter_is_the_gather_adjoint():
    """The scatter half of the fused op is the adjoint of its gather:
    <y, op(A) x> = <op(A^T) y, x>; and the kernel's CSR lists run in
    ascending slot order within each dof."""
    rng = np.random.default_rng(1)
    nb, m, n = 9, 4, 15
    idx = rng.integers(0, n + 2, size=(nb, m))  # n, n+1 are pads
    A = rng.standard_normal((nb, m, m))
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    op = kernels.GatherGemvScatter(idx, n, "K1", device="cpu")
    yAx = float(torch.as_tensor(y) @ op(torch.as_tensor(A),
                                        torch.as_tensor(x)))
    At = torch.as_tensor(A.transpose(0, 2, 1).copy())
    Aty_x = float(op(At, torch.as_tensor(y)) @ torch.as_tensor(x))
    assert abs(yAx - Aty_x) <= 1e-13 * max(abs(yAx), 1.0)
    offsets, slots = op.offsets.numpy(), op.slots.numpy()
    for k in range(n):
        seg = slots[offsets[k]:offsets[k + 1]]
        assert np.all(np.diff(seg) > 0)
        assert np.all(idx.reshape(-1)[seg] == k)


@pytest.mark.parametrize("masks", ["none", "in", "out", "in_out"])
@pytest.mark.parametrize("m", [6, 12, 14])
def test_fused_op_plain_matches_reference(m, masks):
    rng = np.random.default_rng(100 + m)
    nb, n = 40, 3 * m + 7
    A = rng.standard_normal((nb, m, m))
    x, p = rng.standard_normal(n), rng.standard_normal(n)
    idx = _table(rng, nb, m, n)
    in_mask = (rng.random(n) < 0.7).astype(float) if "in" in masks else None
    out_mask = ((rng.random(n) < 0.7).astype(float) if "out" in masks
                else None)
    op = kernels.GatherGemvScatter(idx, n, "K2", in_mask=in_mask,
                                   out_mask=out_mask, device="cpu")
    out = op(torch.as_tensor(A), torch.as_tensor(x),
             None if out_mask is None else torch.as_tensor(p))
    ref = _reference(A, x, idx, n, in_mask, out_mask, p)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-14, atol=1e-14)


def _loop_reference(A, x, idx, n, in_mask=None, out_mask=None, p=None):
    """The same operation as nested Python loops over blocks, rows and
    columns (no einsum, no add.at)."""
    nb, m = idx.shape
    acc = np.zeros(n)
    for b in range(nb):
        for i in range(m):
            k = idx[b, i]
            if not 0 <= k < n:
                continue
            for j in range(m):
                g = idx[b, j]
                if 0 <= g < n and (in_mask is None or in_mask[g] == 1.0):
                    acc[k] += A[b, i, j] * x[g]
    if out_mask is None:
        return acc
    return np.where(out_mask == 1.0, acc, p)


@pytest.mark.parametrize("masks", ["none", "in_out"])
@pytest.mark.parametrize("m", [1, 27, 65, 138, 189])
def test_fused_op_plain_at_odd_and_long_rows(m, masks):
    """The 3D block sizes (Schoeberl 27, star 138 and 189), m = 1 and the
    first m past the pair kernel's range, against a numpy loop."""
    rng = np.random.default_rng(200 + m)
    nb, n = 3, 2 * m + 5
    A = rng.standard_normal((nb, m, m))
    x, p = rng.standard_normal(n), rng.standard_normal(n)
    idx = _table(rng, nb, m, n)
    mask = (rng.random(n) < 0.7).astype(float) if masks == "in_out" else None
    op = kernels.GatherGemvScatter(idx, n, "K1", in_mask=mask, out_mask=mask,
                                   device="cpu")
    out = op(torch.as_tensor(A), torch.as_tensor(x),
             None if mask is None else torch.as_tensor(p))
    ref = _loop_reference(A, x, idx, n, mask, mask, p)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-13, atol=1e-13)


def test_table_needs_a_column_and_a_known_use():
    with pytest.raises(ValueError, match="m >= 1"):
        kernels.GatherGemvScatter(np.zeros((4, 0), dtype=np.int64), 3, "K1",
                                  device="cpu")
    with pytest.raises(ValueError, match="use must be"):
        kernels.GatherGemvScatter(np.array([[0, 1]]), 3, "K9", device="cpu")
    op = kernels.GatherGemvScatter(np.array([[0, 1, 2]]), 3, "K1",
                                   device="cpu")
    x = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape"):
        op(torch.ones((1, 2, 2), dtype=torch.float64), x)
    # f64 or f32 (the f32 smoother), A, x and passthrough of one dtype
    with pytest.raises(ValueError, match="x must be torch.float32"):
        op(torch.ones((1, 3, 3), dtype=torch.float32), x)
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        op(torch.ones((1, 3, 3), dtype=torch.float16), x.half())


@pytest.mark.parametrize("which", ["in_mask", "out_mask"])
@pytest.mark.parametrize("bad", [0.5, 2.0, -1.0])
def test_non_binary_mask_raises(which, bad):
    mask = np.ones(6)
    mask[2] = bad
    with pytest.raises(ValueError, match="only 0 and 1"):
        kernels.GatherGemvScatter(np.array([[0, 1], [2, 5]]), 6, "K1",
                                  device="cpu", **{which: mask})


def test_passthrough_goes_with_the_out_mask():
    A = torch.ones((2, 2, 2), dtype=torch.float64)
    x = torch.ones(3, dtype=torch.float64)
    idx = np.array([[0, 1], [1, 2]])
    with pytest.raises(ValueError, match="passthrough"):
        kernels.GatherGemvScatter(idx, 3, "K1", out_mask=np.ones(3),
                                  device="cpu")(A, x)
    with pytest.raises(ValueError, match="passthrough"):
        kernels.GatherGemvScatter(idx, 3, "K1", device="cpu")(A, x, x)


def test_cpu_tensors_never_count_launches():
    kernels.reset_launch_counts()
    op = kernels.GatherGemvScatter(np.array([[0, 1], [1, 2]]), 3, "K2",
                                   device="cpu")
    A = torch.ones((2, 2, 2), dtype=torch.float64)
    out = op(A, torch.ones(3, dtype=torch.float64))
    np.testing.assert_array_equal(out.numpy(), [2.0, 4.0, 2.0])
    assert kernels.GatherGemvScatter.launches == {"K1": 0, "K2": 0}
    assert op.launched == 0


KW3 = dict(nref=1, solver_type="almg", hierarchy="uniform", gamma=1e4,
           verbose=False)


@pytest.fixture(scope="module")
def cavity3d():
    """k -> the port's small 3D cavity (ldc3d baseN=2 nref=1): [P2+FB]^3
    (k=2: star m = 189, Schoeberl 27, nld 42) and [P1+FB]^3 (k=1: 138,
    24, 24)."""
    from alfi_torch.problems import ThreeDimLidDrivenCavityProblem

    torch.set_num_threads(1)
    return {k: TorchSolver(ThreeDimLidDrivenCavityProblem(2), k=k,
                           device="cpu", **KW3) for k in (2, 1)}


def _k1_table(solver, kind):
    if kind == "smoother":
        return solver.vmg.patchsets[0], solver.vmg.patch_solvers[0][1]
    ts = solver.vmg.schoeberl[0]
    return ts.patchset, ts.papply


def _live_entries(op):
    """Entries of A the function needs, block by block: (rows that feed
    a live output dof) x (columns that gather a live dof)."""
    nb, m, _ = op.ashape
    rows = np.zeros(nb * m, dtype=bool)
    rows[op.slots.numpy()] = True
    cols = op.gidx.numpy() >= 0
    return int((rows.reshape(nb, m).sum(1) * cols.sum(1)).sum())


@pytest.mark.parametrize("kind", ["smoother", "schoeberl"])
@pytest.mark.parametrize("k, ms", [(2, (189, 27)), (1, (138, 24))])
def test_live_extent_is_the_patch_size_on_3d_tables(cavity3d, k, ms, kind):
    """The K1 tables pad trailing, so a block's live extent is its patch's
    size; the star tables are ragged (most patches are smaller than m)."""
    ps, op = _k1_table(cavity3d[k], kind)
    assert op.m == ms[kind == "schoeberl"]
    np.testing.assert_array_equal(op.ncols.numpy(), ps.sizes)
    assert ps.sizes.max() == op.m
    if kind == "smoother":
        assert np.median(ps.sizes) < op.m


def test_live_extent_with_interleaved_masked_columns():
    """K2: in-masked columns lie between live ones.  The extent is the
    last live column + 1, a masked column before it stays -1 in the
    gather table, and a block that gathers nothing has extent 0."""
    idx = np.array([[0, 1, 2, 3], [4, 1, 5, 0], [1, 1, 7, 1], [2, 3, 4, 5]])
    mask = np.array([1.0, 0.0, 1.0, 1.0, 1.0, 0.0])  # dofs 1 and 5 masked
    op = kernels.GatherGemvScatter(idx, 6, "K2", in_mask=mask, out_mask=mask,
                                   device="cpu")
    np.testing.assert_array_equal(op.ncols.numpy(), [4, 4, 0, 3])
    np.testing.assert_array_equal(op.gidx.numpy()[1], [4, -1, -1, 0])
    np.testing.assert_array_equal(kernels.live_extents(op.gidx.numpy()),
                                  op.ncols.numpy())


@pytest.mark.parametrize("kind", ["smoother", "schoeberl"])
@pytest.mark.parametrize("k", [2, 1])
def test_strided_kernel_loads_what_the_bound_counts_on_k1(cavity3d, k, kind):
    """On a K1 table the strided kernel loads exactly the A entries that
    chip_smoke's bound counts (the pair kernel, where it applies, loads
    whole rows)."""
    cs = _chip_smoke()
    ps, op = _k1_table(cavity3d[k], kind)
    loaded, live = op.a_bytes(2)
    assert live == 8 * _live_entries(op) == 8 * int((ps.sizes ** 2).sum())
    assert loaded == live == cs._bound_bytes(op)["A"]
    padded = 8 * op.m * int(ps.sizes.sum())  # whole rows of live dofs
    assert loaded < padded if kind == "smoother" else loaded <= padded
    if op.m % 2 == 0 and op.m <= kernels.PAIR_MAX_M:
        assert op.a_bytes(1)[0] == 8 * op.m * int(ps.sizes.sum())
    assert op.a_bytes()[0] == op.a_bytes(op.kernel_path())[0]


@pytest.mark.parametrize("k", [2, 1])
def test_strided_kernel_loads_at_least_the_bound_on_k2(cavity3d, k):
    """K2: masked columns before the live extent are loaded (and read 0),
    so the bytes loaded are at least the bound's, for either kernel."""
    cs = _chip_smoke()
    lev = cavity3d[k].vmg.levels[1]
    op = kernels.GatherGemvScatter(lev.rows.numpy(), lev.V.ndof * 3, "K2",
                                   in_mask=lev.mask_flat,
                                   out_mask=lev.mask_flat, device="cpu")
    assert op.in_keep is not None
    live = cs._bound_bytes(op)["A"]
    assert live == 8 * _live_entries(op)
    strided, pair = op.a_bytes(2), op.a_bytes(1)
    assert strided[1] == pair[1] == live
    assert live < strided[0] <= pair[0]


def _emulate_strided_kernel(op, A, x, p=None):
    """The strided kernel in numpy, as the source documents it: per dof
    the rows of its CSR list in list order; of a row the columns below
    the block's live extent, lane t of the table's G lanes adding its
    columns t, t + G, ... in ascending order to one partial across the
    rows; the lanes added by the xor butterfly; a dof whose out-mask is 0
    takes the passthrough.  Reads nothing else of A."""
    nb, m, _ = op.ashape
    gidx = op.gidx.numpy()
    offsets, slots = op.offsets.numpy(), op.slots.numpy()
    slot_cols = op.slot_cols.numpy()
    keep = None if op.out_keep is None else op.out_keep.numpy()
    G = 1 << op.lanes_log2
    rows = A.reshape(nb * m, m)
    out = np.zeros(op.n)
    for k in range(op.n):
        part = np.zeros(G)
        for q in range(offsets[k], offsets[k + 1]):
            s, nc = slots[q], slot_cols[q]
            g = gidx[s // m, :nc]
            xs = np.where(g >= 0, x[np.maximum(g, 0)], 0.0)
            row = rows[s, :nc]
            for j in range(nc):
                part[j % G] += row[j] * xs[j]
        o = G >> 1
        while o:
            part = part + part[np.arange(G) ^ o]
            o >>= 1
        out[k] = part[0] if keep is None or keep[k] else p[k]
    return out


def _ragged_table(rng, nb, m, n):
    """(idx, sizes): block b holds sizes[b] distinct dofs of [0, n), then
    trailing pads (n); the sizes run from 0 to m."""
    sizes = rng.integers(0, m + 1, size=nb)
    sizes[:2] = (0, m)
    idx = np.full((nb, m), n)
    for b in range(nb):
        idx[b, :sizes[b]] = np.sort(rng.choice(n, sizes[b], replace=False))
    return idx, sizes


@pytest.mark.parametrize("masks", ["none", "in_out"])
@pytest.mark.parametrize("m", [1, 24, 27, 42, 65, 138, 189])
def test_strided_kernel_reading_rule_equals_plain(m, masks):
    """The strided kernel's reading rule (emulated in numpy from the host
    tables) gives the plain version's result on a ragged table that has a
    block of size 0 and a full one, bare and masked, with NaN wherever the
    rule must not read: the pad columns and pad rows of A."""
    rng = np.random.default_rng(300 + m)
    nb, n = 5, 2 * m + 5
    idx, sizes = _ragged_table(rng, nb, m, n)
    A = rng.standard_normal((nb, m, m))
    x, p = rng.standard_normal(n), rng.standard_normal(n)
    mask = (rng.random(n) < 0.7).astype(float) if masks == "in_out" else None
    op = kernels.GatherGemvScatter(idx, n, "K1", in_mask=mask, out_mask=mask,
                                   device="cpu")
    if mask is None:
        np.testing.assert_array_equal(op.ncols.numpy(), sizes)
    ref = op.plain(torch.as_tensor(A), torch.as_tensor(x),
                   None if mask is None else torch.as_tensor(p)).numpy()
    pad = np.arange(m)[None, :] >= op.ncols.numpy()[:, None]
    A_nan = A.copy()
    A_nan[np.broadcast_to(pad[:, None, :], A.shape)] = np.nan
    pad_rows = np.arange(m)[None, :] >= sizes[:, None]
    A_nan[np.broadcast_to(pad_rows[:, :, None], A.shape)] = np.nan
    out = _emulate_strided_kernel(op, A_nan, x, p)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13)
    loaded, live = op.a_bytes(2)
    assert loaded >= live and (mask is not None or loaded == live)


@pytest.mark.parametrize("extents, lanes", [
    ([], 4), ([1, 1, 1], 4), ([27] * 10, 4), ([24] * 10, 4),
    ([42] * 10, 8), ([64] * 10, 8), ([65] * 10, 16), ([128] * 10, 16),
    ([189] * 10, 32), ([1590] * 3, 32),
    ([3] * 30 + [189] * 70, 32), ([60] * 80 + [201] * 20, 8)])
def test_strided_lanes_fit_the_rows(extents, lanes):
    """The lanes per dof take the 75 % row in two batches of
    STRIDED_STEPS steps: a few long rows do not widen the group of a
    table of short ones."""
    assert kernels.STRIDED_STEPS == 4 and kernels.LANES_QUANTILE == 0.75
    assert 1 << kernels.strided_lanes_log2(np.array(extents)) == lanes


def test_dispatch_constants_equal_the_source():
    """The wrapper mirrors two constants of the CUDA source."""
    import re

    with open(kernels.SOURCE) as f:
        src = f.read()
    for name, value in (("kMaxM", kernels.PAIR_MAX_M),
                        ("kSteps", kernels.STRIDED_STEPS)):
        found = re.search(r"constexpr int %s = (\d+);" % name, src)
        assert found and int(found.group(1)) == value, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4225, 14), (2048, 6), (8192, 12),
                                   (300, 64), (500, 2), (3000, 42),
                                   (1000, 24), (2000, 27), (300, 138),
                                   (300, 189), (200, 65), (900, 1),
                                   (40, 301), (2000, 27, "ragged"),
                                   (3000, 42, "ragged"),
                                   (300, 189, "ragged"),
                                   (300, 201, "ragged")])
def test_cuda_kernels_match_plain(shape):
    """The fused kernel against its plain version on the card, masked
    (in and out, with passthrough) and unmasked, on full tables (random
    dofs, repeats included) and ragged ones (block sizes 0 .. m from the
    seed, trailing pads), through every kernel that takes the table;
    bitwise equal across two launches; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    nb, m = shape[:2]
    n = nb * m // 3
    rng = np.random.default_rng(0)
    if len(shape) == 3:
        idx, _ = _ragged_table(rng, nb, m, n)
    else:
        idx = rng.integers(0, n + 1, size=(nb, m))  # n is the pad
    mask = (rng.random(n) < 0.8).astype(float)
    A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev)
    x = torch.as_tensor(rng.standard_normal(n), device=dev)
    p = torch.as_tensor(rng.standard_normal(n), device=dev)
    paths = (0, 1, 2) if m % 2 == 0 and m <= kernels.PAIR_MAX_M else (0,)
    for masks, args in (({}, ()),
                        ({"in_mask": mask, "out_mask": mask}, (p,))):
        op = kernels.GatherGemvScatter(idx, n, "K1", device=dev, **masks)
        yp = op.plain(A, x, *args)
        for path in paths:
            op.path = path
            before = kernels.GatherGemvScatter.launches["K1"]
            mine = op.launched
            yk, yk2 = op(A, x, *args), op(A, x, *args)
            torch.cuda.synchronize()
            assert kernels.GatherGemvScatter.launches["K1"] == before + 2
            assert op.launched == mine + 2
            assert torch.equal(yk, yk2)
            err = float((yk - yp).abs().max() / yp.abs().max())
            assert err <= 1e-13
        with pytest.raises(ValueError):
            op(A[:-1], x, *args)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    """The pair kernel, when forced (path 1), raises on an odd m, an m
    above 64 and an A that is not 16-byte aligned; left to choose (path
    0) the wrapper sends all three to the strided kernel, which agrees
    with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    for m in (7, 66):
        op = kernels.GatherGemvScatter(rng.integers(0, 50, size=(10, m)), 50,
                                       "K1", device=dev)
        A = torch.as_tensor(rng.standard_normal((10, m, m)), device=dev)
        x = torch.as_tensor(rng.standard_normal(50), device=dev)
        assert float((op(A, x) - op.plain(A, x)).abs().max()) <= 1e-12
        op.path = 1
        with pytest.raises(ValueError, match="even m"):
            op(A, x)
    nb, m, n = 1000, 14, 3000
    op = kernels.GatherGemvScatter(rng.integers(0, n, size=(nb, m)), n,
                                   "K2", device=dev)
    buf = torch.as_tensor(rng.standard_normal(nb * m * m + 1), device=dev)
    x = torch.as_tensor(rng.standard_normal(n), device=dev)
    A = buf[1:].view(nb, m, m)
    y_strided, y_pair = op(A, x), op(A.clone(), x)
    assert float((y_strided - y_pair).abs().max()) <= 1e-12
    op.path = 1
    with pytest.raises(ValueError, match="aligned"):
        op(A, x)
    op.path = 2
    assert torch.equal(op(A.clone(), x), y_strided)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_sv_tables():
    """On the card, at the Scott-Vogelius tables of ldc2d SV k=2 baseN=4
    nref=1 (bary, macrostar, Burman): the macrostar K1 table (m = 62, the
    pair kernel and the strided one) and the facet blocks (m = 24, the
    blocked route chip_smoke.py times beside the merged level operator),
    against the plain version, bitwise equal over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alfi_torch import ScottVogeliusSolver

    dev = torch.device("cuda")
    sv = ScottVogeliusSolver(
        TorchLDC(4), nref=1, k=2, solver_type="almg", hierarchy="bary",
        patch="macro", stabilisation_type="burman",
        stabilisation_weight=5e-3, gamma=1e4, verbose=False, device=dev)
    rng = np.random.default_rng(14)
    lev = sv.vmg.levels[-1]
    mask = lev.mask_flat
    for idx, use, masks in (
            (sv.vmg.patchsets[0].dofs, "K1", {"out_mask": mask}),
            (sv.vmg.facet_rows[-1], "K2", {"in_mask": mask,
                                           "out_mask": mask})):
        op = kernels.GatherGemvScatter(idx, lev.V.ndof * 2, use,
                                       device=dev, **masks)
        nb, m, _ = op.ashape
        assert m == {"K1": 62, "K2": 24}[use]
        A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev)
        x = torch.as_tensor(rng.standard_normal(op.n), device=dev)
        base = torch.as_tensor(rng.standard_normal(op.n), device=dev)
        for path in (1, 2):
            op.path = path
            yp = op.plain(A, x, base)
            y1, y2 = op(A, x, base), op(A, x, base)
            torch.cuda.synchronize()
            assert torch.equal(y1, y2)
            assert float((y1 - yp).abs().max() / yp.abs().max()) <= 1e-13
