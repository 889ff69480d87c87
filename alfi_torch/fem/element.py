"""Reference finite elements on the unit simplex (host-side tabulation).

Replaces the FIAT/UFL element layer the reference leans on
(alfi/solver.py:574-586, :625-630): Lagrange Pk (k<=5),
discontinuous Lagrange, FacetBubble, and the nodally-enriched Pk+FB space
used for the [P1+FB]^3 / [P2+FB]^3 discretisations.

All elements are *nodal* (point-evaluation dofs) and defined by a span of
polynomials + node locations; tabulation goes through a generalised
Vandermonde solve.  Local node ordering contract (relied on by the dof
numbering in spaces.py and by the bubble split/combine matrices of
transfer/bubble.py, mirroring alfi/bubble.py:42-56):

1. vertex nodes, local vertices 0..d,
2. edge-interior nodes, edges in mesh-local order (2D: edge i opposite
   vertex i; 3D: pairs (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)), each edge's
   nodes ordered from its lower local vertex to its higher,
3. (3D) facet-interior nodes, facet i opposite vertex i,
4. cell-interior nodes, lexicographic in the barycentric multi-index.

FacetBubble nodes sit at facet barycenters, one per facet, facet i
opposite vertex i.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np

# entity kinds for dof association
VERTEX, EDGE, FACET, CELL = 0, 1, 2, 3


def simplex_vertices(d):
    v = np.zeros((d + 1, d))
    for i in range(d):
        v[i + 1, i] = 1.0
    return v


def local_edges(d):
    if d == 2:
        # edge i opposite vertex i, endpoints ascending
        return [(1, 2), (0, 2), (0, 1)]
    return [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def local_facets(d):
    return [tuple(j for j in range(d + 1) if j != i) for i in range(d + 1)]


def _monomials(d, k):
    """Exponent multi-indices of total degree <= k in d vars."""
    exps = [
        e
        for e in itertools.product(range(k + 1), repeat=d)
        if sum(e) <= k
    ]
    return np.array(sorted(exps), dtype=np.int64)


def _eval_monomials(exps, pts):
    # (npts, nmono)
    npts = pts.shape[0]
    out = np.ones((npts, len(exps)))
    for j, e in enumerate(exps):
        for ax, p in enumerate(e):
            if p:
                out[:, j] *= pts[:, ax] ** p
    return out


def _eval_monomial_grads(exps, pts):
    npts = pts.shape[0]
    d = pts.shape[1]
    out = np.zeros((npts, len(exps), d))
    for j, e in enumerate(exps):
        for ax in range(d):
            if e[ax] == 0:
                continue
            g = np.full(npts, float(e[ax]))
            for ax2, p in enumerate(e):
                pp = p - 1 if ax2 == ax else p
                if pp:
                    g *= pts[:, ax2] ** pp
            out[:, j, ax] = g
    return out


def _eval_monomial_hess(exps, pts):
    """(npts, nmono, d, d) second derivatives (for SUPG strong residuals,
    alfi/solver.py:213-214)."""
    npts, d = pts.shape
    out = np.zeros((npts, len(exps), d, d))
    for j, e in enumerate(exps):
        for ax1 in range(d):
            for ax2 in range(d):
                e2 = list(e)
                if ax1 == ax2:
                    if e[ax1] < 2:
                        continue
                    c = e[ax1] * (e[ax1] - 1)
                    e2[ax1] -= 2
                else:
                    if e[ax1] == 0 or e[ax2] == 0:
                        continue
                    c = e[ax1] * e[ax2]
                    e2[ax1] -= 1
                    e2[ax2] -= 1
                g = np.full(npts, float(c))
                for ax, p in enumerate(e2):
                    if p:
                        g *= pts[:, ax] ** p
                out[:, j, ax1, ax2] = g
    return out


def barycentric(pts, d):
    """(npts, d+1) barycentric coords on the reference simplex."""
    lam0 = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.hstack([lam0, pts])


class Element:
    """Nodal element: span functions + point-eval nodes.

    span_eval(pts) -> (npts, nspan); nodes (nloc, d); entity tags per node.
    """

    def __init__(self, dim, degree, nodes, entities, span_eval, span_grad,
                 name, span_hess=None):
        self.dim = dim
        self.degree = degree  # max polynomial degree (for quadrature)
        self.nodes = np.asarray(nodes, float)
        self.nloc = len(self.nodes)
        #: list of tuples (kind, entity_local_id, index_within_entity)
        self.entities = entities
        self._span_eval = span_eval
        self._span_grad = span_grad
        self._span_hess = span_hess
        self.name = name
        V = span_eval(self.nodes)  # (nloc, nspan)
        assert V.shape == (self.nloc, self.nloc), (
            f"{name}: span size {V.shape[1]} != node count {self.nloc}"
        )
        self._coeff = np.linalg.inv(V)  # columns = nodal basis coefficients

    def tabulate(self, pts):
        """(npts, nloc) nodal basis values."""
        return _chop(self._span_eval(pts) @ self._coeff)

    def tabulate_grad(self, pts):
        """(npts, nloc, d) nodal basis gradients."""
        g = self._span_grad(pts)  # (npts, nspan, d)
        return _chop(np.einsum("psd,sl->pld", g, self._coeff))

    def tabulate_hess(self, pts):
        """(npts, nloc, d, d) nodal basis second derivatives."""
        if self._span_hess is None:
            raise NotImplementedError(f"{self.name} has no hessian rule")
        h = self._span_hess(np.atleast_2d(pts))  # (npts, nspan, d, d)
        return _chop(np.einsum("psde,sl->plde", h, self._coeff))

    def __repr__(self):
        return f"{self.name}(d={self.dim})"


def _chop(a, tol=1e-12):
    a = np.asarray(a)
    a[np.abs(a) < tol] = 0.0
    return a


def _pk_nodes(d, k):
    """Pk lattice nodes + entity tags in the module-level ordering."""
    verts = simplex_vertices(d)
    nodes, ents = [], []
    # vertices
    if k >= 1:
        for i in range(d + 1):
            nodes.append(verts[i])
            ents.append((VERTEX, i, 0))
    # edge interiors
    if k >= 2:
        for e, (a, b) in enumerate(local_edges(d)):
            for t in range(1, k):
                nodes.append(verts[a] + (verts[b] - verts[a]) * t / k)
                ents.append((EDGE, e, t - 1))
    # facet interiors (3D only; in 2D the cell block handles the interior)
    if d == 3 and k >= 3:
        for f, tri in enumerate(local_facets(d)):
            idx = 0
            for alpha in _interior_multiindices(3, k):
                pt = sum(verts[tri[j]] * alpha[j] / k for j in range(3))
                nodes.append(pt)
                ents.append((FACET, f, idx))
                idx += 1
    # cell interior
    interior = _interior_multiindices(d + 1, k)
    for idx, alpha in enumerate(interior):
        pt = sum(verts[j] * alpha[j] / k for j in range(d + 1))
        nodes.append(pt)
        ents.append((CELL, 0, idx))
    if k == 0:
        nodes.append(verts.mean(axis=0))
        ents.append((CELL, 0, 0))
    return np.array(nodes), ents


def _interior_multiindices(nverts, k):
    """Multi-indices (len nverts, entries >=1, sum k), lexicographic."""
    return [
        alpha
        for alpha in itertools.product(range(1, k), repeat=nverts)
        if sum(alpha) == k
    ]


@lru_cache(maxsize=None)
def lagrange(d, k):
    nodes, ents = _pk_nodes(d, k)
    exps = _monomials(d, k)
    return Element(
        d, k, nodes, ents,
        lambda p: _eval_monomials(exps, np.atleast_2d(p)),
        lambda p: _eval_monomial_grads(exps, np.atleast_2d(p)),
        f"P{k}",
        span_hess=lambda p: _eval_monomial_hess(exps, np.atleast_2d(p)),
    )


@lru_cache(maxsize=None)
def dg_lagrange(d, k):
    """Discontinuous Pk: same nodes, every dof attached to the cell."""
    nodes, _ = _pk_nodes(d, k)
    exps = _monomials(d, k)
    ents = [(CELL, 0, i) for i in range(len(nodes))]
    return Element(
        d, k, nodes, ents,
        lambda p: _eval_monomials(exps, np.atleast_2d(p)),
        lambda p: _eval_monomial_grads(exps, np.atleast_2d(p)),
        f"DG{k}",
        span_hess=lambda p: _eval_monomial_hess(exps, np.atleast_2d(p)),
    )


def _bubble_eval(d):
    facets = local_facets(d)
    scale = float(d ** d)  # value of prod(lambda) at facet barycenter = d^-d

    def ev(pts):
        pts = np.atleast_2d(pts)
        lam = barycentric(pts, d)
        cols = []
        for tri in facets:
            b = np.ones(len(pts)) * scale
            for j in tri:
                b = b * lam[:, j]
            cols.append(b)
        return np.stack(cols, axis=1)

    def gr(pts):
        pts = np.atleast_2d(pts)
        lam = barycentric(pts, d)
        # dlam/dx: lam0 = 1 - sum x, lam_i = x_i
        dlam = np.zeros((d + 1, d))
        dlam[0, :] = -1.0
        for i in range(d):
            dlam[i + 1, i] = 1.0
        cols = []
        for tri in facets:
            g = np.zeros((len(pts), d))
            for j in tri:
                prod = np.ones(len(pts)) * scale
                for j2 in tri:
                    if j2 != j:
                        prod = prod * lam[:, j2]
                g += prod[:, None] * dlam[j][None, :]
            cols.append(g)
        return np.stack(cols, axis=1)

    def hs(pts):
        pts = np.atleast_2d(pts)
        lam = barycentric(pts, d)
        dlam = np.zeros((d + 1, d))
        dlam[0, :] = -1.0
        for i in range(d):
            dlam[i + 1, i] = 1.0
        cols = []
        for tri in facets:
            H = np.zeros((len(pts), d, d))
            for j1 in tri:
                for j2 in tri:
                    if j1 == j2:
                        continue
                    prod = np.ones(len(pts)) * scale
                    for j3 in tri:
                        if j3 != j1 and j3 != j2:
                            prod = prod * lam[:, j3]
                    H += prod[:, None, None] * np.outer(
                        dlam[j1], dlam[j2])[None, :, :]
            cols.append(H)
        return np.stack(cols, axis=1)

    return ev, gr, hs


@lru_cache(maxsize=None)
def facet_bubble(d):
    """One bubble per facet, nodal at facet barycenters."""
    verts = simplex_vertices(d)
    facets = local_facets(d)
    nodes = np.array([verts[list(tri)].mean(axis=0) for tri in facets])
    ents = [(FACET, f, 0) for f in range(d + 1)]
    ev, gr, hs = _bubble_eval(d)
    return Element(d, d, nodes, ents, ev, gr, f"FB{d}", span_hess=hs)


@lru_cache(maxsize=None)
def pk_facet_bubble(d, k):
    """NodalEnriched(Pk, FacetBubble): Pk nodes then facet-barycenter nodes.

    Matches the reference's velocity element for k < dim
    (alfi/solver.py:576-579) and the dof layout assumed by
    the bubble transfer kernels (alfi/bubble.py:42-44).
    """
    assert 1 <= k < d or (k < d), "enrichment only used for k < dim"
    pk_nodes, pk_ents = _pk_nodes(d, k)
    verts = simplex_vertices(d)
    facets = local_facets(d)
    fb_nodes = np.array([verts[list(tri)].mean(axis=0) for tri in facets])
    nodes = np.vstack([pk_nodes, fb_nodes])
    ents = list(pk_ents) + [(FACET, f, 0) for f in range(d + 1)]
    exps = _monomials(d, k)
    bev, bgr, bhs = _bubble_eval(d)

    def ev(pts):
        pts = np.atleast_2d(pts)
        return np.hstack([_eval_monomials(exps, pts), bev(pts)])

    def gr(pts):
        pts = np.atleast_2d(pts)
        return np.concatenate(
            [_eval_monomial_grads(exps, pts), bgr(pts)], axis=1
        )

    def hs(pts):
        pts = np.atleast_2d(pts)
        return np.concatenate(
            [_eval_monomial_hess(exps, pts), bhs(pts)], axis=1
        )

    return Element(d, max(k, d), nodes, ents, ev, gr, f"P{k}FB",
                   span_hess=hs)
