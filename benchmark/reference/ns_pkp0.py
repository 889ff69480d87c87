"""Plain reference of the discrete steady Navier-Stokes equations that the
lid-driven cavity cells solve: continuous [Pk]^d velocity, k = 1 or 2 (in
3D enriched by one cubic bubble per face, nodally), piecewise-constant
pressure, the augmented-Lagrangian grad-div term on the cell average of
div u, and, where the configuration states a weight, SUPG with the
Shakib-Hughes-Zohan coefficient.

It judges a state; it does not solve.  Given the mesh (vertex coordinates
and cells, each cell's vertex order fixing its reference map), the
Reynolds number and a state (u at the velocity nodes, p per cell), it
assembles the nonlinear residual F(u, p; Re) from first principles and
returns its Euclidean norm, with the Dirichlet rows read as u - g:

    F_v(v) = nu (grad u + grad u^T, grad v)
             + gamma (1/|K|) (div u, 1)_K (div v, 1)_K
             + ((grad u) u, v) - (p, div v)
             + sum_K w (tau(u) L(u, p), (grad v) u)_K    (w = 0: no SUPG)
    F_q(q) = -(div u, q)
    L(u, p) = -nu (lap u + grad div u) + (grad u) u + grad p
    tau(u) = (4 |u|^2 / h^2 + magic (4 nu / h^2)^2)^(-1/2),
    nu = L U / Re,  h = the cell's diameter.

Every integral is taken with the collapsed Gauss-Jacobi rule of the
configuration's degree, the Duffy map from each cell's first vertex, as
the configuration states; the SUPG coefficient is not a polynomial, so
the rule is part of the discrete problem.  The basis is the nodal basis
of span{Pk Lagrange, face bubbles 27 l_a l_b l_c} at the vertices, (k = 2)
edge midpoints and (bubbles) face barycentres, built here in barycentric
coordinates.

Plain torch and numpy only, on any device, in float64.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

DTYPE = torch.float64
#: the largest per-chunk intermediate of the residual's cells, in bytes
CHUNK_BYTES = 256 << 20


# ----------------------------------------------------------------------
# quadrature
# ----------------------------------------------------------------------
def gauss_jacobi(n, alpha):
    """n-point Gauss rule on [0, 1] for the weight (1 - t)^alpha, by the
    Golub-Welsch eigenvalue method on the Jacobi recurrence (beta = 0)."""
    a, b = float(alpha), 0.0
    k = np.arange(n, dtype=np.float64)
    s = 2.0 * k + a + b
    diag = np.where(s == 0, (b - a) / (a + b + 2.0),
                    (b * b - a * a) / np.where(s == 0, 1.0, s * (s + 2.0)))
    k1 = np.arange(1, n, dtype=np.float64)
    s1 = 2.0 * k1 + a + b
    off = np.sqrt(4.0 * k1 * (k1 + a) * (k1 + b) * (k1 + a + b)
                  / (s1 * s1 * (s1 + 1.0) * (s1 - 1.0)))
    x, vec = np.linalg.eigh(np.diag(diag) + np.diag(off, 1)
                            + np.diag(off, -1))
    mu0 = (2.0 ** (a + b + 1.0) * math.gamma(a + 1.0) * math.gamma(b + 1.0)
           / math.gamma(a + b + 2.0))
    w = mu0 * vec[0] ** 2
    return 0.5 * (x + 1.0), w / 2.0 ** (a + 1.0)


def simplex_rule(dim, degree):
    """(barycentric points (nq, dim + 1), weights (nq,) summing to 1/dim!)
    of the collapsed rule exact to ``degree``, the reference cell's origin
    being its vertex 0."""
    n = degree // 2 + 1
    axes = [gauss_jacobi(n, a) for a in range(dim)]
    grids = np.meshgrid(*[t for t, _ in axes], indexing="ij")
    wts = np.ones(1)
    for _, w in axes:
        wts = np.multiply.outer(wts, w)
    wts = wts.reshape(-1)
    g = [x.reshape(-1) for x in grids]
    if dim == 2:
        xi, eta = g
        pts = np.stack([xi * (1 - eta), eta], axis=1)
    elif dim == 3:
        xi, eta, zeta = g
        pts = np.stack([xi * (1 - eta) * (1 - zeta), eta * (1 - zeta), zeta],
                       axis=1)
    else:
        raise ValueError("dim %d" % dim)
    return np.hstack([1.0 - pts.sum(1, keepdims=True), pts]), wts


# ----------------------------------------------------------------------
# the element
# ----------------------------------------------------------------------
def local_entities(dim, degree, bubbles):
    """The reference cell's nodes: vertices, for ``degree`` 2 the edges
    (vertex pairs), and with ``bubbles`` the faces (vertex triples), each
    as a tuple of local vertices; the node sits at their barycentre."""
    if degree not in (1, 2):
        raise ValueError("degree %r: the reference has P1 and P2" % degree)
    verts = [(i,) for i in range(dim + 1)]
    edges = (list(itertools.combinations(range(dim + 1), 2))
             if degree == 2 else [])
    faces = list(itertools.combinations(range(dim + 1), 3)) if bubbles else []
    return verts + edges + faces


def _span(ent, lam, degree):
    """A span function of the entity ``ent`` at barycentric points ``lam``
    (nq, d + 1): value (nq,), d/dlam (nq, d + 1), d2/dlam2 (nq, d+1, d+1).
    Vertex i: l_i (degree 1) or l_i (2 l_i - 1) (degree 2); edge (i, j):
    4 l_i l_j; face (a, b, c): the bubble 27 l_a l_b l_c."""
    nq, nl = lam.shape
    d1 = np.zeros((nq, nl))
    d2 = np.zeros((nq, nl, nl))
    if len(ent) == 1 and degree == 1:
        (i,) = ent
        val = lam[:, i].copy()
        d1[:, i] = 1.0
    elif len(ent) == 1:
        (i,) = ent
        val = lam[:, i] * (2 * lam[:, i] - 1)
        d1[:, i] = 4 * lam[:, i] - 1
        d2[:, i, i] = 4.0
    elif len(ent) == 2:
        i, j = ent
        val = 4 * lam[:, i] * lam[:, j]
        d1[:, i], d1[:, j] = 4 * lam[:, j], 4 * lam[:, i]
        d2[:, i, j] = d2[:, j, i] = 4.0
    else:
        a, b, c = ent
        val = 27 * lam[:, a] * lam[:, b] * lam[:, c]
        for x, y, z in ((a, b, c), (b, a, c), (c, a, b)):
            d1[:, x] = 27 * lam[:, y] * lam[:, z]
            d2[:, y, z] = d2[:, z, y] = 27 * lam[:, x]
    return val, d1, d2


def nodal_basis(dim, degree, bubbles, lam):
    """The nodal basis at barycentric points ``lam``: values (nq, nb),
    first (nq, nb, d + 1) and second (nq, nb, d + 1, d + 1) barycentric
    derivatives, through the inverse of the span's values at the nodes."""
    ents = local_entities(dim, degree, bubbles)
    nodes = np.zeros((len(ents), dim + 1))
    for n, ent in enumerate(ents):
        nodes[n, list(ent)] = 1.0 / len(ent)
    vand = np.stack([_span(e, nodes, degree)[0] for e in ents], axis=1)
    coeff = np.linalg.inv(vand)  # column n: the span coefficients of node n
    parts = [_span(e, lam, degree) for e in ents]
    val = np.stack([p[0] for p in parts], axis=1) @ coeff
    d1 = np.einsum("sqk,sn->qnk", np.stack([p[1] for p in parts]), coeff)
    d2 = np.einsum("sqkl,sn->qnkl", np.stack([p[2] for p in parts]), coeff)
    return val, d1, d2


# ----------------------------------------------------------------------
# the mesh and its nodes
# ----------------------------------------------------------------------
def check_mesh(vertices, cells, extent, n_per_side):
    """Raise unless the cells tile the box [0, extent]^d conformingly on the
    lattice of ``n_per_side`` intervals a side: every vertex on it and
    every lattice point a vertex, positive volumes summing to the box's,
    each interior facet shared by two cells, and the boundary facets'
    measure that of the box's surface."""
    d = vertices.shape[1]
    h = extent / n_per_side
    k = vertices / h
    if np.abs(k - np.round(k)).max() > 1e-9 or k.min() < -1e-9 \
            or k.max() > n_per_side + 1e-9:
        raise ValueError("a vertex lies off the lattice of the box")
    keys = np.unique(np.round(k).astype(np.int64) @ (
        (n_per_side + 1) ** np.arange(d)))
    if len(keys) != len(vertices) or len(keys) != (n_per_side + 1) ** d:
        raise ValueError("the vertices are not the lattice's points")
    X = vertices[cells]
    vol = np.abs(np.linalg.det(X[:, 1:] - X[:, :1])) / math.factorial(d)
    if vol.min() <= 0 or abs(vol.sum() - extent ** d) > 1e-10 * extent ** d:
        raise ValueError("the cells do not fill the box")
    facets = np.sort(np.concatenate(
        [np.delete(cells, i, axis=1) for i in range(d + 1)]), axis=1)
    fac, counts = np.unique(facets, axis=0, return_counts=True)
    if counts.max() > 2:
        raise ValueError("a facet is shared by more than two cells")
    F = vertices[fac[counts == 1]]
    E = F[:, 1:] - F[:, :1]
    meas = np.sqrt(np.abs(np.linalg.det(E @ E.transpose(0, 2, 1)))) \
        / math.factorial(d - 1)
    if abs(meas.sum() - 2 * d * extent ** (d - 1)) > 1e-10 * extent ** d:
        raise ValueError("the boundary facets do not cover the box's "
                         "surface")


def lid_value(problem, x):
    """The Dirichlet data g at points ``x`` (n, d): the regularised lid
    profile on y = 2 of the [0, 2]^d cavity, no slip elsewhere."""
    g = np.zeros_like(x)
    top = np.abs(x[:, 1] - 2.0) < 1e-12
    xx = x[:, 0]
    prof = xx ** 2 * (2 - xx) ** 2 * 0.25 * x[:, 1] ** 2
    if problem == "ldc3d":
        zz = x[:, 2]
        prof = prof * zz ** 2 * (2 - zz) ** 2
    elif problem != "ldc2d":
        raise ValueError("problem %r" % problem)
    g[top, 0] = prof[top]
    return g


class Reference:
    """The discrete problem of a configuration ``spec`` (its ``reference``
    entry: dim, degree, bubbles, quadrature_degree, gamma, supg_weight,
    supg_magic, char_length, char_velocity, extent, problem) on the mesh
    (vertices (nv, d), cells (nc, d + 1)), on ``device``."""

    def __init__(self, vertices, cells, spec, *, device="cpu"):
        vertices = np.asarray(vertices, dtype=np.float64)
        cells = np.asarray(cells, dtype=np.int64)
        d = vertices.shape[1]
        if d != spec["dim"]:
            raise ValueError("a %dD mesh for a %dD configuration"
                             % (d, spec["dim"]))
        self.spec, self.dim = spec, d
        self.device = torch.device(device)
        self.gamma = float(spec["gamma"])
        self.weight = float(spec["supg_weight"])
        self.magic = float(spec["supg_magic"])
        self.char = float(spec["char_length"]) * float(spec["char_velocity"])
        degree, bubbles = int(spec["degree"]), bool(spec["bubbles"])
        ents = local_entities(d, degree, bubbles)

        # global nodes: one per vertex, (P2) edge and (bubbles) face
        node_ids, coords = [], []
        base = 0
        for size in sorted({len(e) for e in ents}):
            cols = [e for e in ents if len(e) == size]
            keys = np.sort(np.stack([cells[:, list(e)] for e in cols], 1), -1)
            flat = keys.reshape(-1, size)
            uniq, inv = np.unique(flat, axis=0, return_inverse=True)
            node_ids.append(base + inv.reshape(len(cells), len(cols)))
            coords.append(vertices[uniq].mean(axis=1))
            base += len(uniq)
        self.cell_nodes = np.concatenate(node_ids, axis=1)
        #: (nn, d) the velocity nodes, (nc, d) the cells' centroids
        self.node_coords = np.concatenate(coords)
        self.cell_centroids = vertices[cells].mean(axis=1)
        self.nnodes = base
        x = self.node_coords
        ext = float(spec["extent"])
        self.bc_nodes = np.flatnonzero(
            ((np.abs(x) < 1e-12) | (np.abs(x - ext) < 1e-12)).any(1))
        self.bc_values = lid_value(spec["problem"], x[self.bc_nodes])

        lam, wts = simplex_rule(d, int(spec["quadrature_degree"]))
        val, d1, d2 = nodal_basis(d, degree, bubbles, lam)

        def dev(a, dtype=DTYPE):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        X = vertices[cells]
        J = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))
        jinv = np.linalg.inv(J)
        glam = np.concatenate([-jinv.sum(1, keepdims=True), jinv], axis=1)
        diam = np.sqrt(((X[:, :, None] - X[:, None]) ** 2).sum(-1))
        self.glam = dev(glam)  # (nc, d + 1, d) physical grad of lambda
        self.detj = dev(np.abs(np.linalg.det(J)))
        self.vol = self.detj / math.factorial(d)
        self.h = dev(diam.max(axis=(1, 2)))
        self.w, self.phi = dev(wts), dev(val)
        self.dphi, self.d2phi = dev(d1), dev(d2)
        self.cn = dev(self.cell_nodes, torch.int64)
        nq, nb = val.shape
        self.chunk = max(1, CHUNK_BYTES // (8 * nq * nb * (d + 1) ** 2 * d))

    def _cell_residual(self, uc, pc, glam, detj, vol, h, nu):
        """(rv (c, nb, d), rq (c,)) of the cells of one chunk."""
        phi, dphi = self.phi, self.dphi
        wq = self.w[None, :] * detj[:, None]  # (c, q)
        uq = torch.einsum("qb,cbi->cqi", phi, uc)
        g = torch.einsum("qbk,ckj->cqbj", dphi, glam)  # grad of the basis
        G = torch.einsum("cbi,cqbj->cqij", uc, g)  # G[i, j] = d_j u_i
        div = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
        conv = torch.einsum("cqij,cqj->cqi", G, uq)
        int_div = (wq * div).sum(1)
        int_gv = torch.einsum("cq,cqbj->cbj", wq, g)
        rv = (nu * torch.einsum("cq,cqij,cqbj->cbi", wq, G + G.transpose(-1, -2),
                                g)
              + (self.gamma * int_div / vol)[:, None, None] * int_gv
              + torch.einsum("cq,cqi,qb->cbi", wq, conv, phi)
              - pc[:, None, None] * int_gv)
        if self.weight:
            # second derivatives: H[c,q,i,a,b] = d_a d_b u_i
            U2 = torch.einsum("cbi,qbkl->cqikl", uc, self.d2phi)
            H = torch.einsum("cqikl,cka,clb->cqiab", U2, glam, glam)
            lap = torch.einsum("cqiaa->cqi", H)
            grad_div = torch.einsum("cqaai->cqi", H)
            Lu = -nu * (lap + grad_div) + conv  # grad p = 0 for P0
            tau = (4.0 * (uq * uq).sum(-1) / h[:, None] ** 2
                   + self.magic * (4.0 * nu / h[:, None] ** 2) ** 2) ** -0.5
            at = torch.einsum("cqbj,cqj->cqb", g, uq)  # (grad v) u
            rv = rv + torch.einsum("cq,cqi,cqb->cbi", self.weight * wq * tau,
                                   Lu, at)
        return rv, -int_div

    def residual(self, u, p, re):
        """(F_v (nn, d) with the Dirichlet rows u - g, F_q (nc,)) of the
        state u (nn, d) at the reference's nodes and p (nc,) per cell, at
        Reynolds number ``re`` (> 0)."""
        u = torch.as_tensor(u, dtype=DTYPE, device=self.device)
        p = torch.as_tensor(p, dtype=DTYPE, device=self.device)
        nu = self.char / float(re)
        Fv = torch.zeros_like(u)
        Fq = torch.empty_like(p)
        for c in range(0, self.cn.shape[0], self.chunk):
            s = slice(c, c + self.chunk)
            rv, rq = self._cell_residual(
                u[self.cn[s]], p[s], self.glam[s], self.detj[s],
                self.vol[s], self.h[s], nu)
            Fv.index_add_(0, self.cn[s].reshape(-1), rv.reshape(-1, self.dim))
            Fq[s] = rq
        bc = torch.as_tensor(self.bc_nodes, device=self.device)
        Fv[bc] = u[bc] - torch.as_tensor(self.bc_values, dtype=DTYPE,
                                         device=self.device)
        return Fv, Fq

    def residual_norm(self, u, p, re):
        """||F(u, p; Re)||_2 over every row, the Dirichlet rows as u - g."""
        Fv, Fq = self.residual(u, p, re)
        return math.sqrt(float((Fv * Fv).sum()) + float((Fq * Fq).sum()))
