"""The merged level operator (kernels KA, the assembly, and KM, the
apply) against the JAX package, its plain versions and numpy, f64 on the
CPU; and the CUDA kernels against their plain versions (on a card only).

Tables: ldc2d SV k=2 bary macrostar with Burman (baseN=2 nref=1), ldc3d
SV k=3 (baseN=1 nref=1), ldc3d [P2+FB]^3 (baseN=2 nref=1), ldc2d [P2]^2
(baseN=2 nref=1), and the 2D step on tests/fixtures/bfs2d_coarse06.msh
(an outflow: components left unmasked on the boundary).

* the host pattern holds each distinct live (row, column) coupling of the
  cell and facet blocks once, block columns ascending; every live block
  entry is a source of exactly the merged entry of its coupling, no
  masked one is;
* KA's plain version, expanded to a dense matrix, is the dense assembly
  from the blocks (``assemble_dense_from_tensors``) at 1e-13;
* ``VelocityMG.level_apply`` on the merged operator equals the JAX
  package's ``level_apply`` from the blocks at 1e-12 (summation order
  only), with and without Burman's facet tensors;
* numpy emulations of KM's lane and butterfly order and of KA's source
  order equal the plain versions at 1e-13.
"""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver, ScottVogeliusSolver, kernels
from alfi_torch.mg import level_operator
from alfi_torch.mg.level_operator import LevelPattern
from alfi_torch.problems import ThreeDimLidDrivenCavityProblem as LDC3
from alfi_torch.problems import TwoDimBackwardsFacingStepProblem as BFS2
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as LDC2
from alfi_torch.solvers.linear import assemble_dense_from_tensors

SV = dict(solver_type="almg", hierarchy="bary", patch="macro",
          stabilisation_type="burman", stabilisation_weight=5e-3, gamma=1e4,
          verbose=False)
CP = dict(solver_type="almg", hierarchy="uniform", gamma=1e4, verbose=False)
STEP_MESH = "tests/fixtures/bfs2d_coarse06.msh"
BUILD = {
    "sv2d": lambda dev: ScottVogeliusSolver(LDC2(2), nref=1, k=2,
                                            device=dev, **SV),
    "sv3d": lambda dev: ScottVogeliusSolver(LDC3(1), nref=1, k=3,
                                            device=dev, **SV),
    "ldc3d": lambda dev: ConstantPressureSolver(LDC3(2), nref=1, k=2,
                                                device=dev, **CP),
    "ldc2d": lambda dev: ConstantPressureSolver(LDC2(2), nref=1, k=2,
                                                device=dev, **CP),
}
#: small enough for a dense check
DENSE = ("sv2d", "sv3d", "ldc3d", "ldc2d")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solvers():
    torch.set_num_threads(1)
    return {name: build("cpu") for name, build in BUILD.items()}


@pytest.fixture(scope="module")
def step():
    """The 2D step's level 0 (50,990 dofs; the outflow is unmasked)."""
    import os

    torch.set_num_threads(1)
    here = os.path.dirname(os.path.abspath(__file__))
    return ConstantPressureSolver(
        BFS2(os.path.join(os.path.dirname(here), STEP_MESH)), nref=1, k=2,
        device="cpu", **CP)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _blocks(solver, l, seed):
    """Random cell (and, with Burman, facet) tensors of level l."""
    rng = np.random.default_rng(seed)
    op = solver.vmg.level_ops[l]
    T = torch.as_tensor(rng.standard_normal(op.cell_shape))
    F = (None if op.facet_shape is None
         else torch.as_tensor(rng.standard_normal(op.facet_shape)))
    return T, F


def _levels():
    return [(name, l) for name in DENSE for l in (0, 1)]


def _source_couplings(solver, l):
    """(row, col) flat dofs of every block entry, cells then facets, in
    source-position order."""
    vmg = solver.vmg
    out = []
    for rows in (vmg.levels[l].rows.numpy(), vmg.facet_rows[l]):
        if rows is None:
            continue
        m = rows.shape[1]
        out.append(np.stack([np.repeat(rows, m, axis=1).reshape(-1),
                             np.tile(rows, (1, m)).reshape(-1)]))
    return np.concatenate(out, axis=1)


def _merged_couplings(op):
    """(row, col) flat dofs of every merged entry."""
    p, d = op.pattern, op.d
    e = np.arange(p.nnzb * d * d)
    blk, i, j = e // (d * d), (e // d) % d, e % d
    brow = np.repeat(np.arange(p.nodes), p.row_lengths)
    return np.stack([brow[blk] * d + i, p.bcol[blk].astype(np.int64) * d + j])


def _check_pattern(solver, l):
    op = solver.vmg.level_ops[l]
    p, d = op.pattern, op.d
    keep = p.keep
    src_rc = _source_couplings(solver, l)
    live = keep[src_rc[0]] & keep[src_rc[1]]
    assert src_rc.shape[1] == p.nsource and int(live.sum()) == p.nlive
    # the blocks: each distinct live node pair once, columns ascending
    nn = p.nodes
    want = np.unique((src_rc[0] // d * nn + src_rc[1] // d)[live])
    brow = np.repeat(np.arange(nn), p.row_lengths)
    got = brow * nn + p.bcol
    assert np.array_equal(got, want)
    assert np.all(np.diff(got) > 0)
    # the map: every live source once, no masked one, each into the
    # merged entry of its own coupling, ascending within each entry
    src = p.amap_src.astype(np.int64)
    assert len(src) == p.nlive
    assert np.array_equal(np.sort(src), np.flatnonzero(live))
    dest = np.repeat(np.arange(len(p.amap_ptr) - 1), np.diff(p.amap_ptr))
    assert np.array_equal(_merged_couplings(op)[:, dest], src_rc[:, src])
    same = dest[1:] == dest[:-1]
    assert np.all(src[1:][same] > src[:-1][same])


@pytest.mark.parametrize("name, l", _levels())
def test_pattern_holds_each_live_coupling_once(solvers, name, l):
    _check_pattern(solvers[name], l)


def test_pattern_on_the_step_keeps_the_outflow(step):
    """The 2D step: its outflow components stay live, so boundary nodes
    keep rows, and the pattern is held as above."""
    _check_pattern(step, 0)
    op = step.vmg.level_ops[0]
    keep = op.pattern.keep.reshape(-1, 2)
    assert (~keep).any()
    # a node with some component live has a row, a masked node none
    live_nodes = keep.any(axis=1)
    assert np.all(op.pattern.row_lengths[live_nodes] > 0)
    assert np.all(op.pattern.row_lengths[~live_nodes] == 0)


@pytest.mark.parametrize("name, l", _levels())
def test_plain_assembly_is_the_dense_assembly(solvers, name, l):
    s = solvers[name]
    lev, op = s.vmg.levels[l], s.vmg.level_ops[l]
    T, F = _blocks(s, l, 20 + l)
    vals = op.plain_assemble(T, F)
    n, d = op.n, op.d
    dense = np.zeros((n, n))
    rc = _merged_couplings(op)
    dense[rc[0], rc[1]] = vals.numpy().reshape(-1)
    dense += np.diag(1.0 - op.pattern.keep)
    want = assemble_dense_from_tensors(
        lev.form, T, lev.mask_u, facet_tensors=F,
        facet_rows=s.vmg.facet_rows[l]).numpy()
    assert _rel(dense, want) < 1e-13


@pytest.mark.parametrize("name, l", _levels())
def test_plain_apply_is_the_dense_apply(solvers, name, l):
    s = solvers[name]
    op = s.vmg.level_ops[l]
    T, F = _blocks(s, l, 30 + l)
    vals = op.plain_assemble(T, F)
    x = torch.as_tensor(np.random.default_rng(31).standard_normal(op.n))
    lev = s.vmg.levels[l]
    A = assemble_dense_from_tensors(lev.form, T, lev.mask_u, facet_tensors=F,
                                    facet_rows=s.vmg.facet_rows[l])
    assert _rel(op.plain(vals, x), A @ x) < 1e-13


@pytest.fixture(scope="module")
def jax_solvers():
    """The JAX package's twins of the 2D SV and [P2]^2 solvers."""
    from alfi_tpu import ConstantPressureSolver as JaxCP
    from alfi_tpu import ScottVogeliusSolver as JaxSV
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC2

    return {"sv2d": JaxSV(JaxLDC2(2), nref=1, k=2, **SV),
            "ldc2d": JaxCP(JaxLDC2(2), nref=1, k=2, **CP)}


@pytest.mark.parametrize("name, facets", [("sv2d", True), ("sv2d", False),
                                          ("ldc2d", False)])
@pytest.mark.parametrize("l", [0, 1])
def test_level_apply_matches_jax(solvers, jax_solvers, name, facets, l):
    """Twins of test_torch_burman.py's level apply with facets and
    test_torch_kernels_ref.py's without: the merged operator's apply
    against the JAX package's from the blocks.  ``facets`` False on the
    SV level runs the cell blocks alone (zero facet tensors here, none
    there)."""
    import jax.numpy as jnp

    t, j = solvers[name], jax_solvers[name]
    T, F = _blocks(t, l, 40 + l)
    if F is not None and not facets:
        F = torch.zeros_like(F)
    v = np.random.default_rng(41).standard_normal((t.vmg.levels[l].V.ndof,
                                                   2))
    out_t = t.vmg.level_apply(l, t.vmg.level_assemble(l, T, F),
                              torch.as_tensor(v))
    out_j = j.vmg.level_apply(l, jnp.asarray(T.numpy()), jnp.asarray(v),
                              ftensors=jnp.asarray(F.numpy()) if facets
                              else None)
    assert _rel(out_t, out_j) < 1e-12


def test_level_apply_matches_jax_3d(solvers):
    """SV k=3 in 3D with facets: the JAX package's level apply."""
    import jax.numpy as jnp
    from alfi_tpu import ScottVogeliusSolver as JaxSV
    from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem as JaxLDC3

    t = solvers["sv3d"]
    j = JaxSV(JaxLDC3(1), nref=1, k=3, **SV)
    T, F = _blocks(t, 1, 42)
    v = np.random.default_rng(43).standard_normal((t.vmg.levels[1].V.ndof,
                                                   3))
    out_t = t.vmg.level_apply(1, t.vmg.level_assemble(1, T, F),
                              torch.as_tensor(v))
    out_j = j.vmg.level_apply(1, jnp.asarray(T.numpy()), jnp.asarray(v),
                              ftensors=jnp.asarray(F.numpy()))
    assert _rel(out_t, out_j) < 1e-12


def emulate_assembly(op, T, F=None):
    """KA as the source documents it: per merged entry, its sources in the
    map's order, added one by one from 0."""
    p = op.pattern
    src = T.numpy().reshape(-1)
    if F is not None:
        src = np.concatenate([src, F.numpy().reshape(-1)])
    ptr = p.amap_ptr.astype(np.int64)
    counts = np.diff(ptr)
    acc = np.zeros(len(counts))
    for k in range(int(counts.max(initial=0))):
        has = counts > k
        acc[has] = acc[has] + src[p.amap_src[ptr[:-1][has] + k]]
    return acc.reshape(op.vshape)


def emulate_apply(op, vals, x):
    """KM as the source documents it: G = 2^lanes_log2 lanes per node row,
    lane t takes the row's blocks t, t + G, ... in ascending order and
    keeps d partials, each updated over j ascending; then an xor butterfly
    over the lanes; a masked component takes x."""
    p, d = op.pattern, op.d
    G = 1 << op.lanes_log2
    vals, x = vals.numpy(), x.numpy()
    start = p.rowptr[:-1].astype(np.int64)
    length = p.row_lengths
    steps = -(-int(length.max(initial=0)) // G)
    part = np.zeros((p.nodes, G, d))
    for s in range(steps):
        q = start[:, None] + s * G + np.arange(G)[None, :]
        has = q < (start + length)[:, None]
        qs = np.where(has, q, 0)
        xb = x.reshape(-1, d)[p.bcol[qs]]  # (nodes, G, d)
        a = vals[qs]  # (nodes, G, d, d)
        for i in range(d):
            for j in range(d):
                part[:, :, i] = np.where(
                    has, part[:, :, i] + a[:, :, i, j] * xb[:, :, j],
                    part[:, :, i])
    o = G // 2
    while o:
        part = part + part[:, np.arange(G) ^ o]
        o //= 2
    return np.where(p.keep, part[:, 0].reshape(-1), x)


@pytest.mark.parametrize("name, l", _levels())
def test_emulated_kernels_equal_the_plain_versions(solvers, name, l):
    s = solvers[name]
    op = s.vmg.level_ops[l]
    T, F = _blocks(s, l, 50 + l)
    vals = op.plain_assemble(T, F)
    assert _rel(emulate_assembly(op, T, F), vals) < 1e-13
    x = torch.as_tensor(np.random.default_rng(51).standard_normal(op.n))
    assert _rel(emulate_apply(op, vals, x), op.plain(vals, x)) < 1e-13


@pytest.mark.parametrize("lanes", [0, 2, 5])
def test_emulated_apply_at_every_lane_count(solvers, lanes):
    """The butterfly and the lane stride at 1, 4 and 32 lanes, on the 3D
    SV fine level (rows of up to a few hundred blocks)."""
    op = solvers["sv3d"].vmg.level_ops[1]
    T, F = _blocks(solvers["sv3d"], 1, 52)
    vals = op.plain_assemble(T, F)
    x = torch.as_tensor(np.random.default_rng(53).standard_normal(op.n))
    op.lanes_log2, own = lanes, op.lanes_log2
    try:
        assert _rel(emulate_apply(op, vals, x), op.plain(vals, x)) < 1e-13
    finally:
        op.lanes_log2 = own


@pytest.mark.parametrize("lengths, d, lanes", [
    ([], 3, 0), ([1, 2, 2, 2], 2, 0), ([3, 4, 4, 4], 2, 1), ([9] * 8, 2, 3),
    ([27] * 8, 3, 5), ([12] * 8, 3, 4), ([200] * 8, 2, 5),
    ([1] * 6 + [400] * 2, 2, 5)])
def test_merged_lanes_fit_the_rows(lengths, d, lanes):
    assert kernels.merged_lanes_log2(np.array(lengths), d) == lanes


def test_lanes_follow_the_table(solvers):
    """KM's lanes come from the pattern alone (the rows' lengths), never
    from the device, so the CPU tests run the card's reading order."""
    for s in solvers.values():
        for op in s.vmg.level_ops:
            assert op.lanes_log2 == kernels.merged_lanes_log2(
                op.pattern.row_lengths, op.d)


def test_setup_assembles_every_applied_level(solvers):
    """setup's level_ops: None at level 0 (solved densely), the merged
    values of the cell and facet tensors above."""
    s = solvers["sv2d"]
    params = s.params()
    state = s.vmg.setup(s.z[0], params, s._transfer_setup(params),
                        s._almg_static, p_fine=s.z[1])
    assert state["level_ops"][0] is None
    vals = s.vmg.level_assemble(1, state["tensors"][1], state["ftensors"][1])
    assert torch.equal(state["level_ops"][1], vals)


def test_arguments_are_checked(solvers):
    s = solvers["sv2d"]
    op = s.vmg.level_ops[1]
    T, F = _blocks(s, 1, 60)
    with pytest.raises(ValueError, match="facet tensors"):
        op.assemble(T)
    with pytest.raises(ValueError, match="shape"):
        op.assemble(T[:-1].contiguous(), F)
    with pytest.raises(ValueError, match="contiguous"):
        op.assemble(T.transpose(1, 2), F)
    vals = op.assemble(T, F)
    with pytest.raises(ValueError, match="shape"):
        op(vals, torch.zeros(op.n + 1, dtype=torch.float64))
    # f64 or f32 values and vectors (the precision modes), nothing else
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        op(vals.half(), torch.zeros(op.n, dtype=torch.float32))
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        op(vals, torch.zeros(op.n, dtype=torch.float16))
    ldc = solvers["ldc2d"].vmg.level_ops[1]
    with pytest.raises(ValueError, match="facet tensors"):
        ldc.assemble(*_blocks(solvers["ldc2d"], 1, 61)[:1], F)


def test_pattern_rejects_what_it_cannot_hold(solvers):
    lev = solvers["ldc2d"].vmg.levels[1]
    rows, n = lev.rows.numpy(), lev.V.ndof * 2
    keep = lev.mask_flat.numpy()
    with pytest.raises(ValueError, match="node blocks"):
        LevelPattern(rows[:, ::-1], n, 2, keep)
    with pytest.raises(ValueError, match="0 and 1"):
        LevelPattern(rows, n, 2, 0.5 * keep)
    with pytest.raises(ValueError, match="keep has"):
        LevelPattern(rows, n, 2, keep[:-1])


def test_pattern_raises_past_int32(solvers, monkeypatch):
    lev = solvers["ldc2d"].vmg.levels[1]
    monkeypatch.setattr(level_operator, "INT32_LIMIT", 1000)
    with pytest.raises(ValueError, match="int32"):
        LevelPattern(lev.rows.numpy(), lev.V.ndof * 2, 2,
                     lev.mask_flat.numpy())


def test_cpu_tables_never_count_launches(solvers):
    kernels.reset_launch_counts()
    s = solvers["sv2d"]
    op = s.vmg.level_ops[1]
    T, F = _blocks(s, 1, 62)
    op(op.assemble(T, F), torch.zeros(op.n, dtype=torch.float64))
    assert kernels.MergedLevelOperator.launches == {"KM": 0, "KA": 0}
    assert op.launched == {"KM": 0, "KA": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BUILD))
def test_cuda_kernels_match_plain(name):
    """KA and KM on the card against their plain versions at every level
    of the small tables (the host patterns of a CPU solver, bound to the
    card), 1e-13, two launches bitwise equal, one launch counted per
    call; and at 1, 4 and 32 lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    s = BUILD[name]("cpu")
    for l, host in enumerate(s.vmg.level_ops):
        op = kernels.MergedLevelOperator(host.pattern, device=dev)
        T, F = (None if t is None else t.to(dev) for t in _blocks(s, l, 70))
        want = host.plain_assemble(T.cpu(), None if F is None else F.cpu())
        v1, v2 = op.assemble(T, F), op.assemble(T, F)
        x = torch.as_tensor(np.random.default_rng(71).standard_normal(op.n),
                            device=dev)
        yp = op.plain(v1, x)
        lane_counts = sorted({op.lanes_log2, 0, 2, 5})
        for lanes in lane_counts:
            op.lanes_log2 = lanes
            y1, y2 = op(v1, x), op(v1, x)
            torch.cuda.synchronize()
            assert torch.equal(y1, y2)
            assert _rel(y1.cpu(), yp.cpu()) <= 1e-13, lanes
        torch.cuda.synchronize()
        assert torch.equal(v1, v2)
        assert _rel(v1.cpu(), want) <= 1e-13
        assert op.launched["KA"] == 2
        assert op.launched["KM"] == 2 * len(lane_counts)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("keep, km_bytes, ka_bytes", [
    ([1, 1, 1, 1], 224, 388), ([1, 1, 0, 0], 116, 100)])
def test_merged_bounds_count_what_the_functions_need(keep, km_bytes,
                                                     ka_bytes):
    """chip_smoke's KM and KA bounds on one cell of two 2-dof nodes
    (rows [[0, 1, 2, 3]], n = 4).  Live: 4 blocks of 2 x 2; KM moves their
    values (128 B), block columns (16), rowptr (12), x at 4 dofs (32), the
    mask (4) and out (32); KA reads the 16 sources (128) and the map (64 +
    68) and writes 16 values (128).  Node 1 masked: one block (32 + 4),
    rowptr (12), x at the 2 gathered and the 2 passed-through dofs (32),
    mask, out; KA 4 sources, map 16 + 20, 4 values."""
    cs = _chip_smoke()
    op = kernels.MergedLevelOperator(
        LevelPattern(np.array([[0, 1, 2, 3]]), 4, 2, np.array(keep, float)),
        device="cpu")
    km_ms, km_by = cs._merged_bound(op)
    ka_ms, ka_by = cs._assembly_bound(op)
    assert km_by == ka_by == "bytes"
    assert km_ms == pytest.approx(1e3 * km_bytes / cs.HBM_BYTES_PER_S,
                                  rel=1e-12)
    assert ka_ms == pytest.approx(1e3 * ka_bytes / cs.HBM_BYTES_PER_S,
                                  rel=1e-12)
