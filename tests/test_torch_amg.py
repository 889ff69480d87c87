"""The port's smoothed-aggregation AMG (alfi_torch.mg.amg), the LSC Schur
PC and the modes alamg, simple and lsc against the JAX package's, f64 on
the CPU, ldc2d [P2]^2-P0 baseN=4 nref=1 (the configuration of
tests/test_alamg.py and tests/test_simple_mode.py):

* the host tables, given the same inputs: the scalar adjacency, the
  aggregates and the tables of P equal to the JAX package's arrays
  exactly, P's values at 1e-14; the hierarchy each package builds from
  its own static tensors the same (n1, P at 1e-14);
* the dense level-1 Galerkin matrix at one seeded state at 1e-12; the
  plain version of KA over the Galerkin map equal to the einsum plus
  scatter it replaces (numpy, 1e-13);
* one AMG V-cycle at 1e-10, LSCSchurPC.schur_inverse at 1e-10;
* twins of tests/test_alamg.py's three tests and
  tests/test_simple_mode.py's two, each with the JAX package's counts;
* the card's ladders of the three modes at the bench config (committed
  harness logs) against the JAX package's CPU logs;
* on the card (marked cuda, skipped without one): KA over the Galerkin
  map against its plain version, 1e-13, two launches bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch import kernels
from alfi_torch.mg import amg as tamg
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_torch.solvers.fieldsplit import LSCSchurPC as TorchLSC
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.mg import amg as jamg
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC
from alfi_tpu.solvers.fieldsplit import LSCSchurPC as JaxLSC

KW = dict(nref=1, k=2, hierarchy="uniform", verbose=False)
PARAMS = {"nu": 0.1, "gamma": 10.0, "advect": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _make(gamma, solver_type, jax=False):
    """The tests/test_alamg.py solver: Re=10 parameters set."""
    if jax:
        s = JaxSolver(JaxLDC(4), solver_type=solver_type, gamma=gamma, **KW)
    else:
        s = TorchSolver(TorchLDC(4), solver_type=solver_type, gamma=gamma,
                        device="cpu", **KW)
    s.advect_val = 1.0
    s.nu_val = s.char_L * s.char_U / 10.0
    return s


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)
    return _make(10.0, "alamg"), _make(10.0, "alamg", jax=True)


def _host_inputs(ts):
    """(cell dofs, scalar ndof, A_s, d) of the port's solver, as
    VelocityAMG builds them."""
    from scipy.sparse import coo_matrix

    from alfi_torch.solvers.linear import vector_rows

    V = ts.Z.V
    rows = vector_rows(V)
    K, G = ts.form._static_velocity_tensors()
    T_s = K.numpy() + ts.gamma * G.numpy()
    m = ts.bcset.mask[0].numpy().reshape(-1)
    r = np.repeat(rows[:, :, None], rows.shape[1], axis=2).reshape(-1)
    c = np.repeat(rows[:, None, :], rows.shape[1], axis=1).reshape(-1)
    N = V.ndof * 2
    A_s = coo_matrix((T_s.reshape(-1) * m[r] * m[c], (r, c)),
                     shape=(N, N)).tocsr()
    return V.cell_dofs.astype(np.int64), V.ndof, A_s


def test_host_tables_equal_jax(pair):
    ts, _ = pair
    cd, ndof, A_s = _host_inputs(ts)
    at, aj = tamg._scalar_adjacency(cd, ndof), jamg._scalar_adjacency(cd,
                                                                      ndof)
    assert np.array_equal(at.indptr, aj.indptr)
    assert np.array_equal(at.indices, aj.indices)
    (gt, nt), (gj, nj) = tamg.aggregate(at), jamg.aggregate(aj)
    assert nt == nj and np.array_equal(gt, gj)
    Pt = tamg.smoothed_prolongator(A_s, gt, nt, 2)
    Pj = jamg.smoothed_prolongator(A_s, gj, nj, 2)
    assert np.array_equal(Pt.indptr, Pj.indptr)
    assert np.array_equal(Pt.indices, Pj.indices)
    assert _rel(Pt.data, Pj.data) <= 1e-14
    (it, wt), (ij, wj) = tamg.csr_to_tables(Pt), jamg.csr_to_tables(Pj)
    assert np.array_equal(it, ij) and np.array_equal(wt, wj)


def _dense_p(idx, w, n1):
    P = np.zeros((idx.shape[0], n1))
    np.add.at(P, (np.arange(idx.shape[0])[:, None], idx), w)
    return P


def test_hierarchy_equals_jax(pair):
    """The same hierarchy from each package's own static tensors: P equal
    at 1e-14 as a matrix.  Its tables may differ by entries of 1e-17: the
    two packages' static tensors differ at round-off, and scipy drops the
    products that cancel exactly in one and not the other."""
    ts, js = pair
    t, j = ts.vamg, js.vamg
    assert (t.n1, len(t.P_deep)) == (j.n1, len(j.P_deep))
    Pt = _dense_p(t.p_idx.numpy(), t.p_w.numpy(), t.n1)
    Pj = _dense_p(np.asarray(j.p_idx), np.asarray(j.p_w), j.n1)
    assert _rel(Pt, Pj) <= 1e-14


def _tensors(ts, seed=5):
    """The velocity Jacobian's cell tensors at a seeded wind."""
    rng = np.random.default_rng(seed)
    wind = torch.as_tensor(rng.standard_normal((ts.Z.V.ndof, 2)))
    return wind, ts.form.velocity_element_tensors(PARAMS, wind)


def test_galerkin_matrix_matches_jax(pair):
    ts, js = pair
    _, T = _tensors(ts)
    At = ts.vamg._galerkin1(T.contiguous())
    Aj = js.vamg._galerkin1(jnp.asarray(T.numpy()))
    assert _rel(At.numpy(), Aj) <= 1e-12


def test_galerkin_map_equals_scatter(pair):
    """KA's plain version over the Galerkin map against the per-cell
    contributions scattered into a dense matrix by numpy (pads and
    masked rows included, as the JAX package scatters them)."""
    ts, _ = pair
    vamg = ts.vamg
    _, T = _tensors(ts, seed=6)
    nc, nld = T.shape[:2]
    k = vamg.kmax
    Pw = vamg.cell_pw.numpy().reshape(nc, nld, k)
    contrib = np.einsum("cia,cij,cjb->ciajb", Pw, T.numpy(),
                        Pw).reshape(nc, nld * k, nld * k)
    from alfi_torch.solvers.linear import vector_rows

    cell_pidx = vamg.p_idx.numpy()[vector_rows(ts.Z.V)].reshape(nc, -1)
    want = np.zeros((vamg.n1, vamg.n1))
    np.add.at(want, (cell_pidx[:, :, None], cell_pidx[:, None, :]), contrib)
    (_, _, ka), = vamg.galerkin  # one chunk at this size
    got = ka.plain(torch.as_tensor(contrib).reshape(-1))
    assert _rel(got.numpy().reshape(vamg.n1, vamg.n1), want) <= 1e-13
    # every map entry reads a live contribution, each at most once
    src = ka.amap_src.numpy()
    assert len(np.unique(src)) == len(src) == ka.nsrc


def test_galerkin_chunks_sum_to_the_whole(pair, monkeypatch):
    """With the cells split into chunks (one KA map each, summed in
    order), the Galerkin matrix is the one-chunk matrix to 1e-13."""
    ts, _ = pair
    _, T = _tensors(ts, seed=10)
    whole = ts.vamg._galerkin1(T.contiguous())
    m = ts.vamg.cell_pw.shape[1]
    monkeypatch.setattr(tamg, "GALERKIN_CHUNK", 37 * m * m)
    chunked = tamg.VelocityAMG(ts)
    assert len(chunked.galerkin) == -(-ts.form.geom.detj.shape[0] // 37)
    assert _rel(chunked._galerkin1(T.contiguous()).numpy(),
                whole.numpy()) <= 1e-13


def _states(pair):
    ts, js = pair
    wind, _ = _tensors(ts)
    p = torch.zeros(ts.Z.Q.ndof, dtype=torch.float64)
    st = ts.vamg.setup(wind, PARAMS, p_fine=p)
    jp = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in PARAMS.items()}
    sj = js.vamg.setup(jnp.asarray(wind.numpy()), jp,
                       p_fine=jnp.asarray(p.numpy()))
    return st, sj


def test_vcycle_matches_jax(pair):
    ts, js = pair
    st, sj = _states(pair)
    assert abs(st["lmax"] - float(sj["lmax"])) <= 1e-12 * st["lmax"]
    r = (np.random.default_rng(7).standard_normal((ts.Z.V.ndof, 2))
         * ts.bcset.mask[0].numpy())
    out_t = ts.vamg.make_solve_A(st)(torch.as_tensor(r)).numpy()
    out_j = np.asarray(js.vamg.make_solve_A(sj)(jnp.asarray(r)))
    assert _rel(out_t, out_j) <= 1e-10


def test_lsc_schur_inverse_matches_jax(pair):
    ts, js = pair
    st, sj = _states(pair)
    mt, mj = ts.bcset.mask[0], js.bcset.mask[0]
    lt = TorchLSC(ts.form, mt, None,
                  lambda v: ts.vamg.level_apply(st["vals"], v), True)
    lj = JaxLSC(js.form, mj, None,
                lambda v: js.vamg.level_apply(sj["tensors"], None, v), True)
    s = np.random.default_rng(8).standard_normal(ts.Z.Q.ndof)
    out_t = lt.schur_inverse(torch.as_tensor(s), PARAMS).numpy()
    out_j = np.asarray(lj.schur_inverse(jnp.asarray(s), PARAMS))
    assert _rel(out_t, out_j) <= 1e-10


# ----------------------------------------------------------------------
# twins of tests/test_alamg.py
# ----------------------------------------------------------------------
def test_alamg_solves_moderate_gamma():
    out = []
    for jax in (False, True):
        _, info = _make(10.0, "alamg", jax=jax).solve(10)
        assert info["converged"]
        out.append((int(info["linear_iter"]), int(info["nonlinear_iter"])))
    assert out[0] == out[1]
    assert out[0][0] / max(1, out[0][1]) < 60


def test_alamg_loses_robustness_at_high_gamma():
    counts = {}
    for jax in (False, True):
        for st in ("alamg", "almg"):
            s = _make(1e4, st, jax=jax)
            params = s.params()
            F = s.residual_masked(s.z, params)
            _, its = s._linear_step(s.z, F, params, s._transfer_setup(params)
                                    if getattr(s, "_transfer_setup", None)
                                    else None)
            counts[st, jax] = int(its)
    assert counts["alamg", False] == counts["alamg", True], counts
    assert counts["almg", False] == counts["almg", True], counts
    assert counts["alamg", False] >= 3 * counts["almg", False], counts


def test_alamg_hierarchy_shapes(pair):
    ts, js = pair
    N = ts.Z.V.ndof * 2
    assert 0 < ts.vamg.n1 < N // 3
    assert ts.vamg.p_idx.shape[0] == N == js.vamg.p_idx.shape[0]


# ----------------------------------------------------------------------
# twins of tests/test_simple_mode.py
# ----------------------------------------------------------------------
def _kpn(solver_type, res, jax, **kw):
    if jax:
        s = JaxSolver(JaxLDC(4), solver_type=solver_type, **dict(KW, **kw))
    else:
        s = TorchSolver(TorchLDC(4), solver_type=solver_type, device="cpu",
                        **dict(KW, **kw))
    out = {}
    for re in res:
        _, info = s.solve(re)
        assert info["converged"], (solver_type, re)
        out[re] = (int(info["linear_iter"]), int(info["nonlinear_iter"]))
    return s, out


@pytest.mark.parametrize("mode", ["simple", "lsc"])
def test_baseline_converges_but_degrades(mode):
    """simple and lsc (gamma set to 0) converge at Re 1 and 100 with the
    JAX package's counts, and almg (gamma = 1e4) beats them at Re 100."""
    s, counts = _kpn(mode, [1, 100], False)
    assert s.gamma == 0.0
    _, jcounts = _kpn(mode, [1, 100], True)
    assert counts == jcounts
    _, almg = _kpn("almg", [1, 100], False, gamma=1e4)
    kpn = counts[100][0] / counts[100][1]
    assert almg[100][0] / almg[100][1] < kpn, (counts, almg)


@pytest.mark.parametrize("mode", ["simple", "alamg", "lsc"])
def test_h100_baseline_logs_follow_the_jax_logs(mode):
    """The port's ladders Re 1 -> 10 -> 100 at the bench config on the
    card (committed harness logs) against the JAX package's CPU logs:
    simple equal at every Re.  alamg and lsc stop every linear solve at
    FGMRES's maxit 500 there, in both packages; they are equal at Re 1,
    and beyond it each Newton step still takes 500 (lsc's Re 10 on the card
    once 444), while the Newton trajectory, driven by unconverged linear
    solves, is not reproducible: PERF.md, PR 9."""
    import os

    from alfi_torch.examples.compare_iters import solve_records

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "iters_ldc2d_nref2_re100_%s" % mode
    port = solve_records(os.path.join(repo, "results", "torch_h100",
                                      name + ".log"))
    ref = solve_records(os.path.join(repo, "results", "torch_h100",
                                     name + "_jax_cpu.log"))
    assert sorted(port) == sorted(ref) == [1, 10, 100]
    if mode == "simple":
        assert port == ref
        return
    assert port[1] == ref[1]
    for re in (10, 100):
        (k, n), (kj, nj) = port[re], ref[re]
        assert kj == 500 * nj and 500 * (n - 1) < k <= 500 * n


@pytest.mark.cuda
def test_cuda_galerkin_assembly_matches_plain(pair):
    """KA over the Galerkin map on the card against its plain version
    (the map of the CPU solver, bound to the card): 1e-13, two launches
    bitwise equal, one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ts, _ = pair
    (_, _, g), = ts.vamg.galerkin
    op = kernels.MapAssembly(g.amap_ptr.numpy(), g.amap_src.numpy(),
                             g.ncell, device=dev)
    src = torch.as_tensor(np.random.default_rng(9).standard_normal(g.ncell),
                          device=dev)
    kernels.reset_launch_counts()
    a, b = op(src), op(src)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert _rel(a.cpu().numpy(), g.plain(src.cpu()).numpy()) <= 1e-13
    assert op.launched == 2 == kernels.MapAssembly.launches["KG"]
