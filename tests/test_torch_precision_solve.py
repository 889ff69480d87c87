"""The SUPG ladder Re 1, 10, 100, 1000 at ldc2d baseN=8 nref=1 (the
config of ``tests/test_mixed_cycle.py``'s ``_solver``) in each precision
mode, through the port and the JAX package (CPU, the packages' setters).

Each mode's counts equal the JAX package's in the same mode within one
Krylov iteration per Newton step (the same Newton counts), and meet the
JAX package's gates against the port's own f64 control
(``tests/test_mixed_cycle.py``): the defect-correction smoother and f32
storage at c64 + 1 per Re, the f32 cycle at 1.10 c64 + 1.  Measured on the
CPU: f64 [8, 7, 18, 49]; dc32 and mg_store the same; the f32 cycle [8, 7,
20, 52] against the JAX package's [8, 7, 20, 53].
"""

import numpy as np
import pytest
import torch

RES = [1, 10, 100, 1000]
KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False, stabilisation_type="supg")
GATES = {"dc32": (1.0, 1), "store32": (1.0, 1), "cycle32": (1.10, 1)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _set_mode(mode):
    import jax.numpy as jnp

    from alfi_tpu import config as jconfig
    from alfi_torch import config as tconfig

    for cfg, f32, f64 in ((tconfig, torch.float32, torch.float64),
                          (jconfig, jnp.float32, jnp.float64)):
        cfg.set_mg_dtype(f32 if mode == "cycle32" else f64)
        cfg.set_mg_store(f32 if mode in ("store32", "cycle32") else f64)
        cfg.set_mg_smooth_dtype(f32 if mode in ("dc32", "cycle32") else f64)


def _sweep(solver):
    counts = []
    for re in RES:
        _, info = solver.solve(re)
        assert info["converged"], re
        counts.append((info["linear_iter"], info["nonlinear_iter"]))
    return np.array(counts)


def _torch_sweep():
    from alfi_torch import ConstantPressureSolver
    from alfi_torch.problems import TwoDimLidDrivenCavityProblem

    return _sweep(ConstantPressureSolver(TwoDimLidDrivenCavityProblem(8),
                                         device="cpu", **KW))


@pytest.fixture(scope="module")
def control():
    """The port's f64 counts."""
    torch.set_num_threads(1)
    _set_mode("f64")
    return _torch_sweep()


@pytest.mark.parametrize("mode", sorted(GATES))
def test_supg_ladder_in_each_mode(control, mode):
    from alfi_tpu import ConstantPressureSolver
    from alfi_tpu.problems import TwoDimLidDrivenCavityProblem

    _set_mode(mode)
    try:
        mine = _torch_sweep()
        jax = _sweep(ConstantPressureSolver(TwoDimLidDrivenCavityProblem(8),
                                            **KW))
    finally:
        _set_mode("f64")
    k, n = mine[:, 0], mine[:, 1]
    assert np.array_equal(n, jax[:, 1]), (mine.tolist(), jax.tolist())
    assert np.all(k <= jax[:, 0] + jax[:, 1]), (mine.tolist(), jax.tolist())
    scale, plus = GATES[mode]
    assert np.all(k <= scale * control[:, 0] + plus), (control.tolist(),
                                                       mine.tolist())
