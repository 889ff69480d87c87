"""Parity of the port's multigrid (alfi_torch.mg) with the JAX package on
ldc2d baseN=4 nref=1, f64 on the CPU: the point-evaluation transfers,
the Schoeberl prolongation/restriction and one full-multigrid
application of the velocity-block preconditioner (make_solve_A).

Tolerance: normwise relative 1e-7.  The transfers agree to round-off;
the Schoeberl and FMG paths apply gamma=1e4 patch operators with
condition numbers up to ~1e8, through explicit inverses in the port and
LU solves in the JAX CPU path (docs/DESIGN.md:34-44)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
PARAMS = {"nu": 0.02, "gamma": 1e4, "advect": 1.0}


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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("op", ["prolong", "restrict", "inject"])
def test_transfers_match_jax(solvers, op):
    t, j = solvers
    nc, nf = t.vmg.levels[0].V.ndof, t.vmg.levels[1].V.ndof
    if op == "prolong":
        x = _rand((nc, 2), 1)
        out = (t.vmg.prolongs[0].apply(torch.as_tensor(x)),
               j.vmg.prolongs[0].apply(jnp.asarray(x)))
    elif op == "restrict":
        x = _rand((nf, 2), 2)
        out = (t.vmg.prolongs[0].apply_transpose(torch.as_tensor(x)),
               j.vmg.prolongs[0].apply_transpose(jnp.asarray(x)))
    else:
        x = _rand((nf, 2), 3)
        out = (t.vmg.injects[0].apply(torch.as_tensor(x)),
               j.vmg.injects[0].apply(jnp.asarray(x)))
    assert _rel(*out) < 1e-7


@pytest.mark.parametrize("op", ["prolong", "restrict"])
def test_schoeberl_matches_jax(solvers, op):
    t, j = solvers
    ts, js = t.vmg.schoeberl[0], j.vmg.schoeberl[0]
    st_t = ts.setup(PARAMS, static=t._almg_static["schoeberl"][0])
    jparams = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    st_j = js.setup(jparams, static=j._almg_static["schoeberl"][0])
    if op == "prolong":
        x = _rand((t.vmg.levels[0].V.ndof, 2), 4)
        out = (ts.prolong(st_t, torch.as_tensor(x)),
               js.prolong(st_j, jnp.asarray(x)))
    else:
        x = _rand((t.vmg.levels[1].V.ndof, 2), 5)
        out = (ts.restrict(st_t, torch.as_tensor(x)),
               js.restrict(st_j, jnp.asarray(x)))
    assert _rel(*out) < 1e-7


def test_fmg_solve_A_matches_jax(solvers):
    """One full-multigrid cycle (the velocity-block preconditioner) at a
    state carried into both packages from numpy."""
    t, j = solvers
    nv, nq = t.Z.V.ndof, t.Z.Q.ndof
    mask = t.bcset.mask[0].numpy()
    u = mask * 0.1 * _rand((nv, 2), 6) + t.bcset.values[0].numpy()
    p = _rand((nq,), 7)
    rv = mask * _rand((nv, 2), 8)

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
