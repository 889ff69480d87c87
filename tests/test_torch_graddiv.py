"""The port's grad-div study (alfi_torch.graddiv, the Chebyshev-driven
W-cycle options of VelocityMG, cg and chebyshev) against the JAX
package's, f64 on the CPU, on the unit square baseN=4 nref=1 with
[P2]^2-P0 (pkp0) unless stated:

* cg and chebyshev on one seeded SPD operator under a Jacobi PC: the
  same iterates at 1e-12 and the same iteration count;
* the VelocityMG pieces at gamma = 1e4: the Arnoldi eigenvalue estimate
  of every smoothed level at 1e-10, the Jacobi diagonals (read off the
  merged level operator) at 1e-12, one W-cycle with patch smoothers
  (the port's explicit patch inverses against the JAX package's LU
  solves, condition numbers up to ~1e8) at 1e-7 normwise, with Schoeberl
  and with standard transfers;
* the load vector at 1e-12;
* gamma_sweep's counts at gamma 0 and 1e4 for patch +- transfer, Jacobi
  and AMG: equal at gamma 0, and for patch + transfer at 1e4; the rows
  that are not gamma-robust run 50-150 CG iterations at 1e4, where a
  relative 1e-14 change of the load moves the count (shown below), so
  there they are held to the chip's rule (within 10 % or 2);
* one Scott-Vogelius case (bary, macrostar): equal counts;
* ``python -m alfi_torch.examples.graddiv``'s printed rows equal the JAX
  harness's committed CPU log of the Makefile's pkp02dcomparison target
  (patch + transfer, baseN=8 nref=2);
* the card's 3D rows (committed log) follow the JAX package's 3D log by
  the chip's rule, but for one recorded cell.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch.graddiv import GradDivSolver as TorchGD
from alfi_torch.graddiv import gamma_sweep as torch_sweep
from alfi_torch.solvers import krylov as tkrylov
from alfi_tpu.graddiv import GradDivSolver as JaxGD
from alfi_tpu.graddiv import gamma_sweep as jax_sweep
from alfi_tpu.solvers import krylov as jkrylov

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(baseN=4, nref=1, k=2, smoothing=3)
GAMMA = 1e4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _spd(n=40, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n), rng.standard_normal(n)


def test_cg_matches_jax():
    A, b = _spd()
    dinv = 1.0 / np.diag(A)
    At = torch.as_tensor(A)
    xt, it = tkrylov.cg(lambda v: At @ v, torch.as_tensor(b),
                        pc=lambda r: torch.as_tensor(dinv) * r, rtol=1e-10)
    xj, ij = jkrylov.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                        pc=lambda r: jnp.asarray(dinv) * r, rtol=1e-10)
    assert it["converged"] and bool(ij["converged"])
    assert it["iters"] == int(ij["iters"])
    assert _rel(xt.numpy(), xj) <= 1e-12


def test_chebyshev_matches_jax():
    A, b = _spd(seed=1)
    dinv = 1.0 / np.diag(A)
    lmax = float(np.linalg.eigvals(dinv[:, None] * A).real.max())
    At = torch.as_tensor(A)
    x0 = np.random.default_rng(2).standard_normal(len(b))
    xt = tkrylov.chebyshev(lambda v: At @ v, torch.as_tensor(b),
                           lambda r: torch.as_tensor(dinv) * r,
                           x0=torch.as_tensor(x0), maxit=4, lmax=lmax)
    xj = jkrylov.chebyshev(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                           lambda r: jnp.asarray(dinv) * r,
                           x0=jnp.asarray(x0), maxit=4, lmax=lmax)
    assert _rel(xt.numpy(), xj) <= 1e-12


def _pair(**kw):
    torch.set_num_threads(1)
    return (TorchGD(device="cpu", **dict(KW, **kw)),
            JaxGD(**dict(KW, **kw)))


def _states(pair, gamma=GAMMA):
    """The W-cycle state of both packages at ``gamma`` (zero wind)."""
    ts, js = pair
    params = {"nu": 1.0, "gamma": gamma, "advect": 0.0}
    zero = torch.zeros((ts.form.V.ndof, 2), dtype=torch.float64)
    st = ts.vmg.setup(zero, params, ts.vmg.transfer_setup(params), None)
    jp = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in params.items()}
    sj = js.vmg.setup(jnp.zeros((js.form.V.ndof, 2)), jp)
    return st, sj


@pytest.fixture(scope="module", params=[
    dict(smoother="patch", transfer=True),
    dict(smoother="patch", transfer=False),
    dict(smoother="jacobi", transfer=True)],
    ids=["patch-transfer", "patch-standard", "jacobi-transfer"])
def mg_pair(request):
    pair = _pair(**request.param)
    return pair, _states(pair)


def test_lmax_matches_jax(mg_pair):
    (ts, _), (st, sj) = mg_pair
    assert len(st["lmax"]) == ts.vmg.nlevels - 1
    for a, b in zip(st["lmax"], sj["lmax"]):
        assert abs(a - float(b)) <= 1e-10 * abs(float(b))


def test_jacobi_diagonal_matches_jax():
    pair = _pair(smoother="jacobi", transfer=False)
    st, sj = _states(pair)
    for dt, dj in zip(st["patch_lufacs"], sj["patch_lufacs"]):
        assert _rel(dt.numpy().reshape(-1), dj) <= 1e-12


def test_wcycle_matches_jax(mg_pair):
    (ts, js), (st, sj) = mg_pair
    r = (np.random.default_rng(3).standard_normal((ts.form.V.ndof, 2))
         * ts.bcset.mask[0].numpy())
    out_t = ts.vmg.make_solve_A(st)(torch.as_tensor(r)).numpy()
    out_j = np.asarray(js.vmg.make_solve_A(sj)(jnp.asarray(r)))
    assert (np.linalg.norm(out_t - out_j)
            <= 1e-7 * np.linalg.norm(out_j))


def test_wcycle_options():
    """The cycle takes the W-cycle, standard transfers when asked, and
    the Jacobi smoother builds no patches."""
    ts = TorchGD(device="cpu", smoother="jacobi", transfer=False, **KW)
    assert ts.vmg.cycle == "w" and ts.vmg.smoother_driver == "chebyshev"
    assert ts.vmg.schoeberl is None and ts.vmg.patchsets == []
    assert ts.vmg.transfer_setup({"nu": 1.0, "gamma": 1.0}) is None


def test_load_matches_jax():
    ts, js = _pair(smoother="patch", transfer=True)
    assert _rel(ts._load.numpy(), js._load) <= 1e-12


@pytest.mark.parametrize("smoother,transfer", [
    ("patch", True), ("patch", False), ("jacobi", True), ("amg", False)])
def test_gamma_sweep_matches_jax(smoother, transfer):
    kw = dict(KW, smoother=smoother, transfer=transfer)
    tc = torch_sweep(gammas=(0.0, GAMMA), device="cpu", **kw)
    jc = jax_sweep(gammas=(0.0, GAMMA), **kw)
    assert tc[0.0] == jc[0.0], (tc, jc)
    if smoother == "patch" and transfer:
        assert tc[GAMMA] == jc[GAMMA], (tc, jc)
    else:
        assert abs(tc[GAMMA] - jc[GAMMA]) <= max(2, 0.1 * jc[GAMMA]), (tc,
                                                                     jc)


def test_count_moves_with_the_load_at_round_off():
    """Why the non-robust rows are held within 10 %: patch smoothing with
    standard transfers at gamma = 1e4 takes a count that a relative
    1e-14 change of the load moves."""
    ts = TorchGD(device="cpu", smoother="patch", transfer=False, **KW)
    counts = set()
    load = ts._load
    for eps in (0.0, 1e-14, -1e-14, 2e-14):
        ts._load = load * (1.0 + eps)
        counts.add(ts.solve(GAMMA)[1])
    assert len(counts) > 1, counts


def test_sv_macrostar_matches_jax():
    kw = dict(baseN=2, nref=1, k=2, discretisation="sv", hierarchy="bary",
              patch="macro", smoother="patch", transfer=True, smoothing=3)
    tc = torch_sweep(gammas=(0.0, GAMMA), device="cpu", **kw)
    jc = jax_sweep(gammas=(0.0, GAMMA), **kw)
    assert tc == jc


def _log_block(path, header):
    """The lines a harness printed for one run of a committed log."""
    with open(path) as f:
        lines = f.read().splitlines()
    i = lines.index(header)
    block = []
    for line in lines[i + 1:]:
        if line.startswith("==="):
            break
        block.append(line)
    return block


def test_example_prints_the_jax_rows():
    from alfi_torch.examples import graddiv

    argv = ["--dim", "2", "--discretisation", "pkp0", "--baseN", "8",
            "--nref", "2", "--k", "2", "--smoother", "patch", "--transfer"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graddiv.main(argv + ["--device", "cpu"])
    want = _log_block(
        os.path.join(REPO, "results", "torch_h100",
                     "graddiv2d_pkp0_jax_cpu.log"),
        "=== python examples/graddiv.py %s ===" % " ".join(argv))
    assert buf.getvalue().splitlines() == want


def _rows_by_args(path):
    """{arguments: iteration cells} of every run of a grad-div log."""
    out, key = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith("==="):
                key = line[line.find("--"):line.rfind("===")].strip()
            elif line.startswith("iters:") and key:
                out[key] = [c.strip() for c in line.split(None, 1)[1].strip()
                            .rstrip("\\").split("\t&")]
    return out


def test_h100_3d_rows_follow_the_jax_log():
    """The card's 3D grad-div rows (committed log) against the JAX
    package's results/logs/graddiv3d_comparison.log by phase 17's rule:
    patch + transfer equal, ">200" where the log says so, elsewhere within
    10 % or 2.  One cell breaks it, recorded here: the [P1+FB]^3 AMG row
    at gamma = 1e3 converges in 198 iterations on the card against the
    log's ">200".  (The SV AMG row, 11.2 G Galerkin contributions, was
    not run.)"""
    from alfi_torch.examples.graddiv import GAMMAS

    port = _rows_by_args(os.path.join(REPO, "results", "torch_h100",
                                      "graddiv3d_comparison.log"))
    ref = _rows_by_args(os.path.join(REPO, "results", "logs",
                                     "graddiv3d_comparison.log"))
    assert len(port) == 9 and set(port) <= set(ref)
    broken = []
    for args, cells in port.items():
        exact = args.endswith("--smoother patch --transfer")
        for g, got, want in zip(GAMMAS, cells, ref[args]):
            if exact or want == ">200":
                ok = got == want
            else:
                ok = got != ">200" and abs(int(got) - int(want)) <= max(
                    2, 0.1 * int(want))
            if not ok:
                broken.append((args.split("--discretisation ")[1][:4]
                               .strip(), args.rsplit("--smoother ")[1], g,
                               got, want))
    assert broken == [("pkp0", "amg", 1e3, "198", ">200")]
