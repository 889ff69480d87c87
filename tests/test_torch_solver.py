"""The whole slice against the JAX package: the almg cavity solve
(ConstantPressureSolver, [P2]^2-P0, ldc2d baseN=4 nref=1, uniform
hierarchy, gamma=1e4) along Re 1 -> 10 -> 100, f64 on the CPU.

* the Krylov and Newton counts equal the JAX run's in the same test;
* the converged states agree to 1e-8 (normwise relative);
* one Newton linear step from a state carried over by
  alfi_torch.interop (the JAX package's npz checkpoint layout) gives an
  update dz that agrees to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch.interop import load_checkpoint, state_from_numpy
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)
RES = [1, 10, 100]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


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
    return t, j, rec


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("re", RES)
def test_counts_equal_jax(sweeps, re):
    _, _, rec = sweeps
    _, it, _, ij = rec[re]
    assert it["converged"] and ij["converged"]
    assert (it["linear_iter"], it["nonlinear_iter"]) == \
        (ij["linear_iter"], ij["nonlinear_iter"])


@pytest.mark.parametrize("re", RES)
def test_states_agree_with_jax(sweeps, re):
    _, _, rec = sweeps
    zt, _, zj, _ = rec[re]
    for a, b in zip(zt, zj):
        assert _rel(a, b) < 1e-8


def test_linear_step_from_checkpoint_matches_jax(sweeps, tmp_path):
    t, j, rec = sweeps
    _, _, (u, p), info = rec[10]
    path = tmp_path / "Re-10.npz"
    np.savez(path, u=u, p=p, numbering="geom2d", nu=info["nu"],
             linear_iter=info["linear_iter"],
             nonlinear_iter=info["nonlinear_iter"], time=info["time"],
             converged=info["converged"])
    z_t, meta = load_checkpoint(path, "cpu")
    assert meta["linear_iter"] == info["linear_iter"]
    assert meta["numbering"] == "geom2d"
    z_j = (jnp.asarray(u), jnp.asarray(p))

    t.nu_val, t.advect_val = 2.0 / 100, 1.0
    j.nu_val, j.advect_val = 2.0 / 100, 1.0
    pt, pj = t.params(), j.params()
    F_t = t.residual_masked(z_t, pt)
    F_j = j.residual_masked(z_j, pj)
    dz_t, its_t = t._linear_step(z_t, F_t, pt, t._transfer_setup(pt))
    dz_j, its_j = j._linear_step(z_j, F_j, pj, j._transfer_setup(pj))
    assert its_t == int(its_j)
    for a, b in zip(dz_t, dz_j):
        assert _rel(a, b) < 1e-8


def test_state_from_numpy_places_f64_on_device():
    z = state_from_numpy(np.zeros((3, 2), np.float32), [1, 2], "cpu")
    assert all(x.dtype == torch.float64 and x.device.type == "cpu"
               for x in z)
    assert z[0].shape == (3, 2) and z[1].tolist() == [1.0, 2.0]


def test_entry_points_default_to_the_card():
    """The solvers run on the card unless the caller asks for the CPU;
    no public callable of the port takes a device that defaults to the
    CPU or to "pick one"."""
    import importlib
    import inspect
    import pkgutil

    import alfi_torch
    from alfi_torch.solver import ConstantPressureSolver, NavierStokesSolver

    for cls in (NavierStokesSolver, ConstantPressureSolver):
        dev = inspect.signature(cls).parameters["device"]
        assert dev.default == "cuda"
    for info in pkgutil.walk_packages(alfi_torch.__path__, "alfi_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if (name.startswith("_") or not callable(obj)
                    or not getattr(obj, "__module__", "").startswith(
                        "alfi_torch")):
                continue
            try:
                params = inspect.signature(obj).parameters
            except (TypeError, ValueError):
                continue
            dev = params.get("device")
            if dev is not None and dev.default is not inspect.Parameter.empty:
                assert dev.default == "cuda", (info.name, name, dev.default)
