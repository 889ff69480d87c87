"""Global configuration for alfi_torch.

The port computes in float64 by default, like the JAX package's CPU
path: the outer Krylov/Newton tolerances (ksp_rtol=1e-9,
snes_atol=1e-8) and the gamma-conditioned patch and coarse
factorisations (kappa ~ gamma/nu * h^-2) need it, and Hopper runs f64
natively.  Every tensor is created with an explicit dtype and device;
importing this module changes no global torch state.

Three precision switches of the velocity multigrid, the JAX package's
(``alfi_tpu/config.py``), narrow what the cycle streams; the
factorisations always stay f64.  Each reads its environment variable
(``f32`` or ``f64``) on first use, and defaults, on every device, to the
compute dtype, as the JAX package does away from the TPU:

* ``mg_dtype`` (``ALFI_TORCH_MG_DTYPE``): the dtype of the whole cycle
  (level applies, smoother arithmetic, transfers, patch applies), cast
  at the preconditioner boundary; ``ALFI_TORCH_MG_F64_KEYS`` names the
  state entries kept in f64 (comma-separated: ``schoeberl``,
  ``patch_lufacs``, and ``tensors``, ``ftensors`` or ``level_ops`` for
  the level operators, which the port merges; none by default, as in the
  JAX package);
* ``mg_store`` (``ALFI_TORCH_MG_STORE``): the storage dtype of the level
  operators and of the static patch parts, with f64 arithmetic;
* ``mg_smooth_dtype`` (``ALFI_TORCH_MG_SMOOTH_DTYPE``): the dtype of the
  level smoother's inner Krylov loop, in defect-correction form (the f64
  defect is smoothed from zero in this dtype, the correction added in
  f64).

An f32 mode on the card runs its f32 products through the port's own
kernels and plain torch; ``VelocityMG`` refuses to set one up while
``torch.backends.cuda.matmul.allow_tf32`` is on, which would round the
plain f32 products (transfers, Gram-Schmidt dots) to TF32.
"""

import os

import numpy as np
import torch

#: dtype of every floating-point tensor the port creates.
real_dtype = torch.float64

#: host-side index dtype of the topology tables (numpy).
index_dtype = np.int32

_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _from_env(name, default):
    env = os.environ.get(name)
    if not env:
        return default()
    if env not in _DTYPES:
        raise ValueError("%s must be f32 or f64, got %r" % (name, env))
    return _DTYPES[env]


_mg_dtype = None


def mg_dtype():
    """dtype of the velocity multigrid CYCLE (ALFI_TORCH_MG_DTYPE;
    default f64)."""
    global _mg_dtype
    if _mg_dtype is None:
        _mg_dtype = _from_env("ALFI_TORCH_MG_DTYPE", lambda: real_dtype)
    return _mg_dtype


def set_mg_dtype(dtype):
    global _mg_dtype
    _mg_dtype = dtype


_mg_store = None


def mg_store():
    """STORAGE dtype of the level operators and the static patch parts
    (ALFI_TORCH_MG_STORE; default the cycle dtype)."""
    global _mg_store
    if _mg_store is None:
        _mg_store = _from_env("ALFI_TORCH_MG_STORE", mg_dtype)
    return _mg_store


def set_mg_store(dtype):
    global _mg_store
    _mg_store = dtype


_mg_smooth = None


def mg_smooth_dtype():
    """COMPUTE dtype of the level smoother's inner Krylov loop
    (ALFI_TORCH_MG_SMOOTH_DTYPE; default the cycle dtype)."""
    global _mg_smooth
    if _mg_smooth is None:
        _mg_smooth = _from_env("ALFI_TORCH_MG_SMOOTH_DTYPE", mg_dtype)
    return _mg_smooth


def set_mg_smooth_dtype(dtype):
    global _mg_smooth
    _mg_smooth = dtype


def mg_f64_keys():
    """The cycle-state entries kept in f64 under an f32 cycle
    (ALFI_TORCH_MG_F64_KEYS, comma-separated; none when unset or empty, as
    the JAX package's ALFI_TPU_MG_F64_KEYS).  The Schoeberl transfer's
    patch solve runs on f32 LU factors unless it names ``schoeberl``
    (``alfi_torch/mg/schoeberl.py``, kernel KL)."""
    return set(k for k in os.environ.get("ALFI_TORCH_MG_F64_KEYS",
                                         "").split(",") if k)
