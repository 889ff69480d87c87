"""Per-cell affine geometry factors (device constants)."""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

from ..config import real_dtype


class CellGeometry:
    """jinv: (nc, d, d) inverse Jacobian; detj: (nc,) |det J|; physical
    gradient of a reference gradient g is jinv^T @ g.  Computed on the
    host in f64 and moved to ``device`` once."""

    def __init__(self, mesh, *, device):
        v = mesh.cell_coords()  # (nc, d+1, d)
        J = np.transpose(v[:, 1:, :] - v[:, :1, :], (0, 2, 1))  # (nc,d,d)
        detj = np.abs(np.linalg.det(J))
        jinv = np.linalg.inv(J)

        def dev(a):
            return torch.as_tensor(a, dtype=real_dtype, device=device)

        self.dim = mesh.dim
        self.jinv = dev(jinv)
        self.detj = dev(detj)
        self.vol = dev(detj / factorial(mesh.dim))
