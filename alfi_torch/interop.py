"""Carry solver state across from numpy and between the two packages'
checkpoints.

Both packages' ``run_solver`` write one npz per Reynolds number with the
keys ``u`` (ndofV, d), ``p`` (ndofQ,), ``numbering`` (the dof-numbering
tag) and the scalar solve record ``nu``, ``linear_iter``,
``nonlinear_iter``, ``time``, ``converged``.  Both packages number dofs
identically (the port's host layer is a copy of the reference's), so a
state loads unchanged either way.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import real_dtype
from .mesh.renumber import geom_numbering_3d_enabled, geom_numbering_enabled

#: the solve record a checkpoint carries beside the state
INFO_KEYS = ("nu", "linear_iter", "nonlinear_iter", "time", "converged")


def numbering_tag():
    """Entity-numbering fingerprint stored in checkpoints: dof vectors
    are meaningless under a different numbering (mesh/renumber.py)."""
    tag = "geom1" if geom_numbering_enabled() else "legacy0"
    if geom_numbering_3d_enabled():
        tag += "+3d"
    return tag


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


def save_checkpoint(path, z, info):
    """Write state ``z`` (u, p) and the solve record ``info`` (the keys
    of INFO_KEYS it has) to ``path`` in the npz layout above, under the
    current numbering tag.  The file is written under a private name and
    renamed, so a reader never sees a half-written checkpoint."""
    tmp = "%s.tmp%d.npz" % (path, os.getpid())
    np.savez(tmp, u=z[0].detach().cpu().numpy(),
             p=z[1].detach().cpu().numpy(), numbering=numbering_tag(),
             **{k: info[k] for k in INFO_KEYS if k in info})
    os.replace(tmp, path)
