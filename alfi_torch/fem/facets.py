"""Interior-facet integration (the JAX package's ``fem/facets.py``).

The reference gets its dS integrals (Burman's edge stabilisation,
alfi/stabilisation.py:156-162) from generated interior-facet kernels.
Here a small set of "configurations" (the ordered local vertex indices of
the facet within the cell) is tabulated once, and every facet side stores
its configuration id.  The facet quadrature points are parametrised by
the facet's global sorted vertex tuple, so the q-th point is the same
physical point from both sides: no matching of points across sides.

The topology tables (``cells``, ``config``) are host numpy; the
tabulations and the geometry are torch tensors on the form's device.
"""

from __future__ import annotations

import itertools
from math import factorial

import numpy as np
import torch

from ..config import real_dtype
from .element import simplex_vertices
from .quadrature import simplex_quadrature


class InteriorFacets:
    """Static tabulations and topology for dS integrals of one space.

    Host (numpy): cells (nif, 2), config (nif, 2).
    Device (torch): normal (nif, d) [outward from side 0], scale (nif,)
    [physical facet measure / reference measure], harea (nif,) [FacetArea
    in 2D, sqrt(FacetArea) in 3D: the reference's Burman h,
    alfi/stabilisation.py:146-151], w (nq,), tab (nconf, nq, nloc),
    gtab (nconf, nq, nloc, d).
    """

    def __init__(self, space, quad_degree, *, device):
        mesh = space.mesh
        elem = space.element
        d = mesh.dim
        self.dim = d
        fidx = mesh.interior_facets
        self.facets = fidx
        nif = len(fidx)
        self.nif = nif

        def dev(a):
            return torch.as_tensor(a, dtype=real_dtype, device=device)

        pts, wts = simplex_quadrature(d - 1, quad_degree)
        pts = np.atleast_2d(pts)
        if d - 1 == 1:
            pts = pts.reshape(-1, 1)
        self.nq = len(wts)
        # barycentric coordinates of the points on the reference facet
        lam = np.hstack([1.0 - pts.sum(axis=1, keepdims=True), pts])

        # configurations: ordered d-tuples of distinct local vertex ids
        verts = simplex_vertices(d)
        configs = list(itertools.permutations(range(d + 1), d))
        cfg_lookup = {c: i for i, c in enumerate(configs)}
        tabs, gtabs = [], []
        for c in configs:
            ref_pts = lam @ verts[list(c)]
            tabs.append(elem.tabulate(ref_pts))
            gtabs.append(elem.tabulate_grad(ref_pts))
        self.tab = dev(np.stack(tabs))
        self.gtab = dev(np.stack(gtabs))
        self.w = dev(wts)

        # per facet side: configuration id
        fv = mesh.facet_vertices[fidx]  # (nif, d) sorted global ids
        fcells = mesh.facet_cells[fidx]  # (nif, 2)
        cfg = np.zeros((nif, 2), dtype=np.int64)
        for s in range(2):
            cells = mesh.cells[fcells[:, s]]  # (nif, d+1)
            # local index of each facet vertex within the cell
            loc = np.argmax(cells[:, None, :] == fv[:, :, None], axis=2)
            cfg[:, s] = [cfg_lookup[tuple(row)] for row in loc]
        self.cells = np.asarray(fcells, dtype=np.int64)
        self.config = cfg

        # geometry: normal outward from side 0, physical measure
        V = mesh.vertices[fv]  # (nif, d, d)
        if d == 2:
            t = V[:, 1] - V[:, 0]
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
            area = np.linalg.norm(t, axis=1)
        else:
            e1, e2 = V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]
            n = np.cross(e1, e2)
            area = 0.5 * np.linalg.norm(n, axis=1)
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        cent0 = mesh.vertices[mesh.cells[fcells[:, 0]]].mean(axis=1)
        mid = V.mean(axis=1)
        flip = np.einsum("fd,fd->f", n, cent0 - mid) > 0
        n[flip] *= -1.0
        self.normal = dev(n)
        self.scale = dev(area / (1.0 / factorial(d - 1)))
        self.harea = dev(area if d == 2 else np.sqrt(area))
