"""Carry solver state across from numpy and from the JAX package's
checkpoints.

The JAX package's ``run_solver`` (``alfi_tpu/driver.py``) writes one npz per
Reynolds number with the keys ``u`` (ndofV, d), ``p`` (ndofQ,),
``numbering`` (the dof-numbering tag) and the scalar solve record
``nu``, ``linear_iter``, ``nonlinear_iter``, ``time``, ``converged``.
Both packages number dofs identically (the port's host layer is a copy
of the reference's), so a state loads unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import real_dtype


def state_from_numpy(u, p, device):
    """(u, p) f64 tensors on ``device`` from array-likes."""
    return (torch.as_tensor(np.asarray(u), dtype=real_dtype, device=device),
            torch.as_tensor(np.asarray(p), dtype=real_dtype, device=device))


def load_checkpoint(path, device):
    """Read a checkpoint in the JAX package's npz layout.

    Returns ``(z, meta)``: the state (u, p) on ``device`` and a dict of
    the remaining entries as Python scalars/strings."""
    with np.load(path) as f:
        z = state_from_numpy(f["u"], f["p"], device)
        meta = {k: f[k].item() for k in f.files if k not in ("u", "p")}
    return z, meta
