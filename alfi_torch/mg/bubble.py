"""Flux-corrected prolongation for [P1+FacetBubble]^3.

Re-design of alfi/bubble.py: the standard nodal prolongation of a coarse
facet bubble underestimates the flux through the coarse facet by exactly
0.625 (bubble.py:4-6), so MG loses the divergence-preservation the AL
solver depends on.  Fix: split the nodal P1FB field into its hierarchical
P1 (+) FB parts, scale the NORMAL component of every coarse bubble by
1/0.625, prolong the parts separately (P1 by vertex interpolation, FB by
point evaluation at fine facet centroids), recombine.

In the port's dof layout ([vertex dofs | facet dofs], fem/spaces.py) the
change of basis is exact dof-level algebra:

    split:    p1 = f[verts],  fb_F = f[F] - mean_{v in F} f[v]
    combine:  f[verts] = p1,  f[F] = fb_F + mean_{v in F} p1[v]

and the facet-normal "mass solve" (bubble.py:26-39) collapses to
v -> v + (1/0.625 - 1)(v.n)n per facet because facet bubbles vanish on
every other facet.  apply_transpose() is the exact adjoint chain.  All of
it is plain torch (gathers, scatter-adds and small einsums), as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..fem import FunctionSpace, facet_bubble, lagrange
from ..fem.scatter import ScatterAdd
from .transfer import prolongation

FLUX_FACTOR = 1.0 / 0.625 - 1.0


def _facet_normals(mesh):
    V = mesh.vertices[mesh.facet_vertices]  # (nf, 3, 3)
    n = np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])
    return n / np.linalg.norm(n, axis=1, keepdims=True)


class BubbleTransfer:
    """apply/apply_transpose with the PointEvalTransfer interface, for
    the VECTOR P1FB space between bary-free hierarchy levels l, l+1."""

    def __init__(self, hierarchy, l, *, device):
        meshc, meshf = hierarchy[l], hierarchy[l + 1]
        if meshc.dim != 3:
            raise ValueError("the bubble flux fix is specific to 3D")
        P1c = FunctionSpace(meshc, lagrange(3, 1))
        P1f = FunctionSpace(meshf, lagrange(3, 1))
        FBc = FunctionSpace(meshc, facet_bubble(3))
        FBf = FunctionSpace(meshf, facet_bubble(3))
        self.p1 = prolongation(hierarchy, l, P1c, P1f, device=device)
        self.fb = prolongation(hierarchy, l, FBc, FBf, device=device)
        self.nvc, self.nvf = meshc.num_vertices, meshf.num_vertices
        self.fvc = torch.as_tensor(meshc.facet_vertices, dtype=torch.int64,
                                   device=device)  # (nfc, 3)
        self.fvf = torch.as_tensor(meshf.facet_vertices, dtype=torch.int64,
                                   device=device)
        self._thirds_c = ScatterAdd(self.fvc, self.nvc)
        self._thirds_f = ScatterAdd(self.fvf, self.nvf)
        self.nc_ = torch.as_tensor(_facet_normals(meshc), dtype=real_dtype,
                                   device=device)

    # -- hierarchical basis algebra -----------------------------------
    def _split(self, f):
        p1 = f[: self.nvc]
        fb = f[self.nvc:] - p1[self.fvc].mean(dim=1)
        return p1, fb

    def _combine_f(self, p1f, fbf):
        facet = fbf + p1f[self.fvf].mean(dim=1)
        return torch.cat([p1f, facet], dim=0)

    def _scale(self, fb):
        nc_ = self.nc_.to(fb.dtype)
        vn = torch.einsum("fd,fd->f", fb, nc_)
        return fb + FLUX_FACTOR * vn[:, None] * nc_

    @staticmethod
    def _add_thirds(v, scatter, facet):
        """v[fv[F, j]] += facet[F] / 3 for the three vertices of every
        facet F (the adjoint of the vertex mean); ``scatter`` sums over
        the facets' vertex table fv."""
        third = (facet / 3.0)[:, None, :].expand(-1, 3, -1)
        return scatter(third.reshape(-1, facet.shape[1]), v)

    # -- forward -------------------------------------------------------
    def apply(self, uc):
        p1, fb = self._split(uc)
        fb = self._scale(fb)
        return self._combine_f(self.p1.apply(p1), self.fb.apply(fb))

    # -- exact adjoint -------------------------------------------------
    def apply_transpose(self, rf):
        # combine^T
        facet = rf[self.nvf:]
        p1f = self._add_thirds(rf[: self.nvf], self._thirds_f, facet)
        # prolong^T
        p1c = self.p1.apply_transpose(p1f)
        fbc = self.fb.apply_transpose(facet)
        # scale^T (= scale) then split^T
        fbc = self._scale(fbc)
        out_v = self._add_thirds(p1c, self._thirds_c, -fbc)
        return torch.cat([out_v, fbc], dim=0)
