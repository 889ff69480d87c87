"""Per-cell affine geometry factors (device constants)."""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

from ..config import real_dtype


class CellGeometry:
    """jinv: (nc, d, d) inverse Jacobian; detj: (nc,) |det J|; h: (nc,)
    cell diameter; physical gradient of a reference gradient g is
    jinv^T @ g.  Computed on the host in f64 and moved to ``device``
    once."""

    def __init__(self, mesh, *, device):
        v = mesh.cell_coords()  # (nc, d+1, d)
        J = np.transpose(v[:, 1:, :] - v[:, :1, :], (0, 2, 1))  # (nc,d,d)
        detj = np.abs(np.linalg.det(J))
        jinv = np.linalg.inv(J)

        def dev(a):
            return torch.as_tensor(a, dtype=real_dtype, device=device)

        self.dim = mesh.dim
        #: (nc, d) first vertex and (nc, d, d) Jacobian of the affine map
        #: x = v0 + J xi
        self.v0 = dev(v[:, 0, :])
        self.J = dev(J)
        self.jinv = dev(jinv)
        self.detj = dev(detj)
        self.vol = dev(detj / factorial(mesh.dim))
        # cell diameter, matching Firedrake's CellSize (the SUPG
        # coefficient's h)
        diff = v[:, :, None, :] - v[:, None, :, :]
        self.h = dev(np.sqrt((diff**2).sum(-1)).max(axis=(1, 2)))

    def quad_points_physical(self, ref_pts):
        """(nc, nq, d) physical coordinates of reference points."""
        ref = torch.as_tensor(np.asarray(ref_pts), dtype=real_dtype,
                              device=self.J.device)
        return self.v0[:, None, :] + torch.einsum("cde,qe->cqd", self.J, ref)
