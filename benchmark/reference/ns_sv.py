"""Plain reference of the discrete steady Navier-Stokes equations that the
Scott-Vogelius cavity cell solves: continuous [P2]^2 velocity and
discontinuous P1 pressure (three nodes a cell, at its vertices) on the
barycentric refinement of the uniform cavity mesh, the exact grad-div
term, and Burman's interior-facet stabilisation.

It judges a state; it does not solve.  Given the mesh (vertex coordinates
and cells), the Reynolds number and a state (u at the velocity nodes, p at
each cell's three pressure nodes), it assembles the nonlinear residual
F(u, p; Re) from first principles and returns its Euclidean norm, with the
Dirichlet rows read as u - g:

    F_v(v) = nu (grad u + grad u^T, grad v) + ((grad u) u, v)
             - (p, div v) + gamma (div u, div v)
             + sum_F 1/2 w h_F^2 beta_F int_F [grad u . n] . [grad v . n]
    F_q(q) = -(div u, q)
    nu = L U / Re,  beta_F = (1/|F|) int_F sqrt(|u|^2 + 1e-10),
    h_F = |F|, the facet's length,

the sum over the interior facets F (edges) of the barycentric mesh, [.]
the jump across F and n either unit normal of F.  These are alfi's forms:
the Scott-Vogelius residual of ``alfi/solver.py`` (ScottVogeliusSolver:
2 nu (sym grad u, grad v) + advect ((grad u) u, v) - (p, div v) + gamma
(div u, div v), and -(div u, q), with advect 1 at Re > 0) and Burman's term
of ``alfi/stabilisation.py:139-162`` (0.5 weight avg(h)^2 beta
dot(jump(grad u, n), jump(grad v, n)) dS, beta = avg(facet_avg(sqrt(
inner(u, u) + 1e-10))), h the FacetArea in 2D).

Departures from the published forms, each where a choice is the
discretisation's own:

* beta_F's facet average is taken with the configuration's
  ``facet_quadrature_points``-point Gauss-Legendre rule on each facet: the
  square root is not a polynomial, so the rule is part of the discrete
  problem (Firedrake picks the degree of ``facet_avg`` itself).  Every
  other integral is of a polynomial and is taken exactly: the cell terms
  (degree 5 at most) by a collapsed Gauss rule exact to degree 6, the
  jump term (degree 2 on a facet) by the same facet rule.
* The Dirichlet rows are u - g (alfi zeroes them after applying g).
* The pressure is taken as given: F does not see a constant pressure
  (every row it enters is of an interior node), so alfi's shift of p to
  mean zero moves nothing here.

Plain torch and numpy only, on any device, in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DTYPE = torch.float64
#: the largest per-chunk intermediate of the residual's cells, in bytes
CHUNK_BYTES = 256 << 20
#: the side of alfi's ldc2d cavity, on whose top the lid's profile lies
EXTENT = 2.0


# ----------------------------------------------------------------------
# quadrature and the P2 basis, in barycentric coordinates
# ----------------------------------------------------------------------
def gauss_legendre01(n):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def triangle_rule(n):
    """(barycentric points (n^2, 3), weights summing to 1/2) of the
    collapsed Gauss rule on the reference triangle: (xi, eta) ->
    (xi (1 - eta), eta) with the Jacobian (1 - eta).  A polynomial of
    total degree k becomes one of degree k in xi and k + 1 in eta, which
    n Gauss points integrate exactly while k <= 2 n - 2."""
    t, w = gauss_legendre01(n)
    xi, eta = (a.ravel() for a in np.meshgrid(t, t, indexing="ij"))
    wts = np.outer(w, w).ravel() * (1.0 - eta)
    pts = np.stack([xi * (1.0 - eta), eta], axis=1)
    return np.hstack([1.0 - pts.sum(1, keepdims=True), pts]), wts


#: the P2 nodes of a triangle: its vertices, then its edges (i, j)
EDGES = ((1, 2), (0, 2), (0, 1))


def p2_basis(lam):
    """The P2 nodal basis at barycentric points ``lam`` (..., 3): values
    (..., 6) and derivatives in the barycentric coordinates (..., 6, 3).
    Vertex i: l_i (2 l_i - 1); edge (i, j): 4 l_i l_j."""
    lam = np.asarray(lam, dtype=np.float64)
    val = np.zeros(lam.shape[:-1] + (6,))
    d1 = np.zeros(lam.shape[:-1] + (6, 3))
    for i in range(3):
        val[..., i] = lam[..., i] * (2.0 * lam[..., i] - 1.0)
        d1[..., i, i] = 4.0 * lam[..., i] - 1.0
    for e, (i, j) in enumerate(EDGES):
        val[..., 3 + e] = 4.0 * lam[..., i] * lam[..., j]
        d1[..., 3 + e, i] = 4.0 * lam[..., j]
        d1[..., 3 + e, j] = 4.0 * lam[..., i]
    return val, d1


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
def barycentric_cavity_mesh(extent, n_per_side):
    """(vertices, cells) of the uniform mesh of [0, extent]^2 with
    ``n_per_side`` squares a side, each cut along its diagonal from
    (1, 0) to (0, 1), then each triangle split at its barycentre into
    three."""
    h = extent / n_per_side
    i, j = (a.ravel() for a in np.meshgrid(np.arange(n_per_side),
                                           np.arange(n_per_side),
                                           indexing="ij"))
    n1 = n_per_side + 1
    v00, v10, v01, v11 = i * n1 + j, (i + 1) * n1 + j, i * n1 + j + 1, \
        (i + 1) * n1 + j + 1
    tris = np.concatenate([np.stack([v00, v10, v01], 1),
                           np.stack([v10, v11, v01], 1)])
    gi, gj = np.meshgrid(np.arange(n1), np.arange(n1), indexing="ij")
    grid = np.stack([gi.ravel(), gj.ravel()], 1) * h
    bary = grid[tris].mean(axis=1)
    b = len(grid) + np.arange(len(tris))
    cells = np.concatenate([np.stack([tris[:, 1], tris[:, 2], b], 1),
                            np.stack([tris[:, 2], tris[:, 0], b], 1),
                            np.stack([tris[:, 0], tris[:, 1], b], 1)])
    return np.concatenate([grid, bary]), cells


def _cell_keys(vertices, cells, step):
    """Each cell as the sorted triple of its vertices' lattice keys."""
    k = np.round(np.asarray(vertices, dtype=np.float64) / step)
    if np.abs(np.asarray(vertices) / step - k).max() > 1e-6 or k.min() < 0:
        raise ValueError("a vertex lies off the lattice of the box")
    k = k.astype(np.int64)
    key = k[:, 0] * (int(k.max()) + 1) + k[:, 1]
    if len(np.unique(key)) != len(key):
        raise ValueError("two vertices share a point")
    tri = np.sort(key[np.asarray(cells)], axis=1)
    return tri[np.lexsort(tri.T[::-1])]


def check_mesh(vertices, cells, extent, n_per_side):
    """Raise unless the mesh is the barycentric refinement of the uniform
    cavity mesh of ``n_per_side`` squares a side (see
    :func:`barycentric_cavity_mesh`): the same vertices and the same
    cells, in any order."""
    vertices = np.asarray(vertices, dtype=np.float64)
    if vertices.ndim != 2 or vertices.shape[1] != 2:
        raise ValueError("not a 2D mesh")
    ev, ec = barycentric_cavity_mesh(extent, n_per_side)
    if len(vertices) != len(ev) or len(cells) != len(ec):
        raise ValueError("the mesh has %d vertices and %d cells, the "
                         "barycentric cavity mesh %d and %d"
                         % (len(vertices), len(cells), len(ev), len(ec)))
    step = extent / n_per_side / 3.0
    if not np.array_equal(_cell_keys(vertices, cells, step),
                          _cell_keys(ev, ec, step)):
        raise ValueError("the cells are not the barycentric cavity mesh's")


def lid_value(x):
    """The Dirichlet data g at points ``x`` (n, 2): the regularised lid
    profile x^2 (2 - x)^2 on y = 2, no slip elsewhere."""
    g = np.zeros_like(x)
    top = np.abs(x[:, 1] - EXTENT) < 1e-12
    xx = x[top, 0]
    g[top, 0] = xx ** 2 * (2 - xx) ** 2 * 0.25 * x[top, 1] ** 2
    return g


# ----------------------------------------------------------------------
# the discrete problem
# ----------------------------------------------------------------------
class Reference:
    """The discrete problem of a configuration ``spec`` (its ``reference``
    entry: gamma, burman_weight, facet_quadrature_points, char_length,
    char_velocity, extent) on the mesh (vertices (nv, 2), cells (nc, 3)),
    on ``device``.  States: u (nnodes, 2) at ``node_coords``, p (nc * 3,)
    at ``pressure_nodes`` (nc, 3, 2) read as p.reshape(nc, 3), row i its
    cell i."""

    def __init__(self, vertices, cells, spec, *, device="cpu"):
        vertices = np.asarray(vertices, dtype=np.float64)
        cells = np.asarray(cells, dtype=np.int64)
        if vertices.shape[1] != 2 or spec.get("dim", 2) != 2:
            raise ValueError("the SV reference is 2D")
        if int(spec.get("degree", 2)) != 2:
            raise ValueError("the SV reference is [P2]^2-P1disc")
        # every product is in float64, which TF32 never touches; off all
        # the same, so that no setting of the process can narrow one
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.gamma = float(spec["gamma"])
        self.weight = float(spec["burman_weight"])
        self.char = float(spec["char_length"]) * float(spec["char_velocity"])
        nv, nc = len(vertices), len(cells)

        # velocity nodes: the vertices, then the edges' midpoints
        edges = np.sort(np.concatenate(
            [cells[:, list(e)] for e in EDGES]), axis=1)
        uniq, inv, counts = np.unique(edges, axis=0, return_inverse=True,
                                      return_counts=True)
        inv = inv.reshape(3, nc).T  # (nc, 3): cell c's edge e
        self.cell_nodes = np.concatenate([cells, nv + inv], axis=1)
        #: (nnodes, 2) velocity nodes, (nc, 2) centroids, (nc, 3, 2) the
        #: pressure's nodes: each cell's vertices in its own vertex order
        self.node_coords = np.concatenate([vertices,
                                           vertices[uniq].mean(axis=1)])
        self.cell_centroids = vertices[cells].mean(axis=1)
        self.pressure_nodes = vertices[cells]
        self.nnodes = len(self.node_coords)
        x = self.node_coords
        ext = float(spec["extent"])
        self.bc_nodes = np.flatnonzero(
            ((np.abs(x) < 1e-12) | (np.abs(x - ext) < 1e-12)).any(1))
        self.bc_values = lid_value(x[self.bc_nodes])

        def dev(a, dtype=DTYPE):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        # cells: physical gradients of the barycentric coordinates
        X = vertices[cells]
        J = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))
        jinv = np.linalg.inv(J)
        glam = np.concatenate([-jinv.sum(1, keepdims=True), jinv], axis=1)
        lam, wts = triangle_rule(4)
        val, d1 = p2_basis(lam)
        self.glam = dev(glam)  # (nc, 3, 2)
        self.detj = dev(np.abs(np.linalg.det(J)))
        self.w, self.phi, self.dphi = dev(wts), dev(val), dev(d1)
        self.lam = dev(lam)  # the P1 pressure basis: lambda itself
        self.cn = dev(self.cell_nodes, torch.int64)
        self.chunk = max(1, CHUNK_BYTES // (8 * len(wts) * 6 * 3 * 4))

        # interior facets: the edges two cells share
        owner = np.repeat(np.arange(nc)[None], 3, 0).T.ravel()
        by_edge = np.argsort(inv.ravel(), kind="stable")
        interior = np.flatnonzero(counts == 2)
        first = np.searchsorted(inv.ravel()[by_edge], interior)
        fc = np.stack([owner[by_edge[first]], owner[by_edge[first + 1]]], 1)
        if (counts > 2).any():
            raise ValueError("an edge is shared by more than two cells")
        A, B = vertices[uniq[interior, 0]], vertices[uniq[interior, 1]]
        t, fw = gauss_legendre01(int(spec["facet_quadrature_points"]))
        xq = A[:, None] + t[None, :, None] * (B - A)[:, None]  # (nf, q, 2)
        length = np.linalg.norm(B - A, axis=1)
        tang = (B - A) / length[:, None]
        normal = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
        side_val, side_grad = [], []
        for s in range(2):
            c = fc[:, s]
            lam_f = np.concatenate(
                [np.zeros(xq.shape[:2] + (1,)),
                 np.einsum("fij,fqj->fqi", jinv[c], xq - X[c, :1])], axis=2)
            lam_f[..., 0] = 1.0 - lam_f[..., 1:].sum(-1)
            v, dl = p2_basis(lam_f)
            side_val.append(dev(v))  # (nf, q, 6)
            # grad of basis n dotted with the normal
            side_grad.append(dev(np.einsum("fqnk,fkj,fj->fqn", dl, glam[c],
                                           normal)))
        self.f_nodes = [dev(self.cell_nodes[fc[:, s]], torch.int64)
                        for s in range(2)]
        self.f_val, self.f_dn = side_val, side_grad
        self.fw = dev(fw)
        # 1/2 w h_F^2 |F|: the facet's coefficient but for beta_F
        self.f_coef = dev(0.5 * self.weight * length ** 2 * length)

    def _cell_residual(self, uc, pc, glam, detj, nu):
        """(rv (c, 6, 2), rq (c, 3)) of the cells of one chunk."""
        wq = self.w[None, :] * detj[:, None]  # (c, q)
        uq = torch.einsum("qb,cbi->cqi", self.phi, uc)
        g = torch.einsum("qbk,ckj->cqbj", self.dphi, glam)  # grad of basis
        G = torch.einsum("cbi,cqbj->cqij", uc, g)  # G[i, j] = d_j u_i
        div = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
        conv = torch.einsum("cqij,cqj->cqi", G, uq)
        pq = torch.einsum("qa,ca->cq", self.lam, pc)
        s = self.gamma * div - pq  # both act on div v
        rv = (nu * torch.einsum("cq,cqij,cqbj->cbi", wq,
                                G + G.transpose(-1, -2), g)
              + torch.einsum("cq,cq,cqbi->cbi", wq, s, g)
              + torch.einsum("cq,cqi,qb->cbi", wq, conv, self.phi))
        rq = -torch.einsum("cq,cq,qa->ca", wq, div, self.lam)
        return rv, rq

    def _burman(self, u):
        """(nf, 6, 2) per side: Burman's facet term on each side's cell
        nodes."""
        u0, u1 = (u[n] for n in self.f_nodes)  # (nf, 6, 2)
        jump = (torch.einsum("fqn,fni->fqi", self.f_dn[0], u0)
                - torch.einsum("fqn,fni->fqi", self.f_dn[1], u1))
        speed = [torch.sqrt((torch.einsum("fqn,fni->fqi", v, us) ** 2)
                            .sum(-1) + 1e-10)
                 for v, us in zip(self.f_val, (u0, u1))]
        beta = 0.5 * (speed[0] + speed[1]) @ self.fw / self.fw.sum()
        cj = (self.f_coef * beta)[:, None, None] * self.fw[None, :, None] \
            * jump  # (nf, q, 2)
        return (torch.einsum("fqi,fqn->fni", cj, self.f_dn[0]),
                -torch.einsum("fqi,fqn->fni", cj, self.f_dn[1]))

    def residual(self, u, p, re):
        """(F_v (nnodes, 2) with the Dirichlet rows u - g, F_q (nc * 3,))
        of the state u (nnodes, 2) at the reference's nodes and p (nc * 3,)
        at its pressure nodes, at Reynolds number ``re`` (> 0)."""
        u = torch.as_tensor(u, dtype=DTYPE, device=self.device)
        p = torch.as_tensor(p, dtype=DTYPE, device=self.device)
        p = p.reshape(-1, 3)
        nu = self.char / float(re)
        Fv = torch.zeros_like(u)
        Fq = torch.empty_like(p)
        for c in range(0, self.cn.shape[0], self.chunk):
            s = slice(c, c + self.chunk)
            rv, rq = self._cell_residual(u[self.cn[s]], p[s], self.glam[s],
                                         self.detj[s], nu)
            Fv.index_add_(0, self.cn[s].reshape(-1), rv.reshape(-1, 2))
            Fq[s] = rq
        for nodes, r in zip(self.f_nodes, self._burman(u)):
            Fv.index_add_(0, nodes.reshape(-1), r.reshape(-1, 2))
        bc = torch.as_tensor(self.bc_nodes, device=self.device)
        Fv[bc] = u[bc] - torch.as_tensor(self.bc_values, dtype=DTYPE,
                                         device=self.device)
        return Fv, Fq.reshape(-1)

    def residual_norm(self, u, p, re):
        """||F(u, p; Re)||_2 over every row, the Dirichlet rows as u - g."""
        Fv, Fq = self.residual(u, p, re)
        return math.sqrt(float((Fv * Fv).sum()) + float((Fq * Fq).sum()))
