"""Function spaces: global dof numbering + cell->dof maps (host-side).

Replaces Firedrake's FunctionSpace/MixedFunctionSpace layer
(alfi/solver.py:574-586,:625-630).  Produces the static
integer maps the device kernels consume:

* ``cell_dofs``   (nc, nloc)  — orientation-consistent for shared edges /
                                faces so CG spaces are conforming,
* ``dof_coords``  (ndof, d)   — node positions (BC evaluation, transfers),
* entity<->dof maps for boundary conditions, patch smoothers and the
  coarse-facet dof masks of the Schoeberl transfer.

Dof layout: [vertex dofs | edge dofs | facet dofs | cell dofs], each block
ordered by entity id then index-within-entity.  Vector-valued spaces store
fields as (ndof, d) arrays; the flattened index is dof*d + component
(the BAIJ-like blocking of alfi/solver.py:512).
"""

from __future__ import annotations

import itertools

import numpy as np

from ..config import index_dtype
from .element import CELL, EDGE, FACET, VERTEX, Element, local_edges, local_facets


_PERMS3 = list(itertools.permutations(range(3)))
_PERM3_LOOKUP = np.full(27, -1, dtype=index_dtype)
for _pid, _p in enumerate(_PERMS3):
    _PERM3_LOOKUP[_p[0] * 9 + _p[1] * 3 + _p[2]] = _pid


def _perm3_id(g):
    """Index (in itertools.permutations(range(3)) order) of argsort per row
    of the (n, 3) id array ``g``."""
    s = np.argsort(g, axis=1)
    return _PERM3_LOOKUP[s[:, 0] * 9 + s[:, 1] * 3 + s[:, 2]]


class FunctionSpace:
    """Scalar function space on a Mesh for a nodal Element."""

    def __init__(self, mesh, element: Element, name=None):
        self.mesh = mesh
        self.element = element
        self.name = name or f"{element.name}_{mesh.name}"
        self.dim = mesh.dim
        self._number_dofs()

    # ------------------------------------------------------------------
    def _number_dofs(self):
        mesh, elem = self.mesh, self.element
        d = self.dim
        ents = elem.entities
        # nodes per entity kind
        self.n_per_vertex = sum(1 for (k, e, i) in ents if k == VERTEX and e == 0)
        edge0 = [(k, e, i) for (k, e, i) in ents if k == EDGE and e == 0]
        self.n_per_edge = len(edge0)
        facet0 = [(k, e, i) for (k, e, i) in ents if k == FACET and e == 0]
        self.n_per_facet = len(facet0)
        self.n_per_cell = sum(1 for (k, e, i) in ents if k == CELL)

        nv = mesh.num_vertices if self.n_per_vertex else 0
        # in 2D facets == edges; treat all 1-dim entities through the
        # mesh's facet table in 2D and the edge table in 3D
        if d == 2:
            n_edges = mesh.num_facets
        else:
            n_edges = mesh.num_edges
        n_facets = mesh.num_facets

        self.off_v = 0
        self.off_e = self.off_v + self.n_per_vertex * (mesh.num_vertices)
        self.off_f = self.off_e + self.n_per_edge * n_edges
        self.off_c = self.off_f + self.n_per_facet * n_facets
        self.ndof = self.off_c + self.n_per_cell * mesh.num_cells

        nc = mesh.num_cells
        nloc = elem.nloc
        cell_dofs = np.empty((nc, nloc), dtype=index_dtype)
        cells = mesh.cells

        # entity connectivity per cell
        if d == 2:
            cell_edges = mesh.cell_facets  # edge i opposite vertex i
        else:
            cell_edges = mesh.cell_edges
        cell_facets = mesh.cell_facets
        ledges = local_edges(d)
        lfacets = local_facets(d)

        # --- fill each local node column
        k = elem.degree  # only used for edge flip arithmetic via n_per_edge
        npe = self.n_per_edge
        npf = self.n_per_facet

        # facet orientation permutations (only needed when npf > 1)
        if npf > 1 and d == 3:
            face_perm = self._face_permutations()
        for ln, (kind, le, idx) in enumerate(ents):
            if kind == VERTEX:
                cell_dofs[:, ln] = self.off_v + cells[:, le]
            elif kind == EDGE:
                a, b = ledges[le]
                flip = cells[:, a] > cells[:, b]
                t = np.where(flip, npe - 1 - idx, idx)
                cell_dofs[:, ln] = self.off_e + cell_edges[:, le] * npe + t
            elif kind == FACET:
                if npf == 1:
                    cell_dofs[:, ln] = self.off_f + cell_facets[:, le]
                else:
                    tri = lfacets[le]
                    g = cells[:, list(tri)]  # (nc, 3) global ids
                    perm_id = _perm3_id(g)
                    m = face_perm[perm_id, idx]  # (nc,)
                    cell_dofs[:, ln] = (
                        self.off_f + cell_facets[:, le] * npf + m
                    )
            elif kind == CELL:
                cell_dofs[:, ln] = (
                    self.off_c
                    + np.arange(nc, dtype=index_dtype) * self.n_per_cell
                    + idx
                )
        self.cell_dofs = cell_dofs

        # dof coordinates: scatter per-cell physical node coords
        v = mesh.cell_coords()  # (nc, d+1, d)
        # affine map: x = v0 + J @ xi
        J = np.transpose(v[:, 1:, :] - v[:, :1, :], (0, 2, 1))  # (nc, d, d)
        phys = v[:, 0, None, :] + np.einsum(
            "cde,ne->cnd", J, elem.nodes
        )  # (nc, nloc, d)
        coords = np.zeros((self.ndof, d))
        coords[cell_dofs.ravel()] = phys.reshape(-1, d)
        self.dof_coords = coords

        # dof -> entity (dim, id) map
        ent_dim = np.empty(self.ndof, dtype=index_dtype)
        ent_id = np.empty(self.ndof, dtype=index_dtype)
        if self.n_per_vertex:
            ent_dim[: self.off_e] = 0
            ent_id[: self.off_e] = np.arange(mesh.num_vertices)
        if npe:
            ent_dim[self.off_e : self.off_f] = 1
            ent_id[self.off_e : self.off_f] = np.repeat(
                np.arange(n_edges), npe
            )
        if npf:
            ent_dim[self.off_f : self.off_c] = d - 1 if d == 3 else 1
            ent_id[self.off_f : self.off_c] = np.repeat(
                np.arange(n_facets), npf
            )
        if self.n_per_cell:
            ent_dim[self.off_c :] = d
            ent_id[self.off_c :] = np.repeat(
                np.arange(nc), self.n_per_cell
            )
        self.dof_entity_dim = ent_dim
        self.dof_entity_id = ent_id

    def _face_permutations(self):
        """(6, npf) tables: canonical face-interior index under each of the
        6 orderings of a face's global vertex ids."""
        elem = self.element
        k = elem.degree
        M = [
            alpha
            for alpha in itertools.product(range(1, k), repeat=3)
            if sum(alpha) == k
        ]
        lookup = {alpha: i for i, alpha in enumerate(M)}
        perms = list(itertools.permutations(range(3)))
        table = np.zeros((6, len(M)), dtype=index_dtype)
        for pid, p in enumerate(perms):
            for i, alpha in enumerate(M):
                table[pid, i] = lookup[tuple(alpha[p[j]] for j in range(3))]
        self._perm_list = perms
        return table

    # ------------------------------------------------------------------
    # entity -> dof queries
    # ------------------------------------------------------------------
    def vertex_dofs(self, verts):
        if not self.n_per_vertex:
            return np.empty(0, dtype=index_dtype)
        return (self.off_v + np.asarray(verts, dtype=index_dtype)).ravel()

    def edge_dofs(self, edges):
        npe = self.n_per_edge
        if not npe:
            return np.empty(0, dtype=index_dtype)
        e = np.asarray(edges, dtype=index_dtype)
        return (
            self.off_e + e[:, None] * npe + np.arange(npe, dtype=index_dtype)
        ).ravel()

    def facet_dofs(self, facets):
        npf = self.n_per_facet
        if not npf:
            return np.empty(0, dtype=index_dtype)
        f = np.asarray(facets, dtype=index_dtype)
        return (
            self.off_f + f[:, None] * npf + np.arange(npf, dtype=index_dtype)
        ).ravel()

    def cell_interior_dofs(self, cells):
        npc = self.n_per_cell
        if not npc:
            return np.empty(0, dtype=index_dtype)
        c = np.asarray(cells, dtype=index_dtype)
        return (
            self.off_c + c[:, None] * npc + np.arange(npc, dtype=index_dtype)
        ).ravel()

    def facet_closure_dofs(self, facets):
        """All dofs on the topological closure of the given facets
        (vertices + edges + the facets themselves)."""
        mesh = self.mesh
        facets = np.asarray(facets, dtype=index_dtype)
        fv = mesh.facet_vertices[facets]
        out = [self.vertex_dofs(np.unique(fv))]
        if mesh.dim == 3:
            fe = np.unique(mesh.facet_edges[facets])
            out.append(self.edge_dofs(fe))
            out.append(self.facet_dofs(facets))
        else:
            # 2D: facets are edges; n_per_edge covers their interiors
            out.append(self.edge_dofs(facets))
            out.append(self.facet_dofs(facets))
        return np.unique(np.concatenate(out))

    def boundary_dofs(self, tags=None):
        """Dofs in the closure of (tagged) exterior facets."""
        return self.facet_closure_dofs(self.mesh.boundary_facets(tags))

    def __repr__(self):
        return f"FunctionSpace({self.name}, ndof={self.ndof})"


class VectorFunctionSpace(FunctionSpace):
    """d components per scalar node; fields stored as (ndof, d)."""

    def __init__(self, mesh, element, name=None):
        super().__init__(mesh, element, name=name)
        self.value_size = mesh.dim

    @property
    def ndof_total(self):
        return self.ndof * self.value_size


class MixedFunctionSpace:
    """Velocity x pressure space; functions are (u, p) pytrees."""

    def __init__(self, V: VectorFunctionSpace, Q: FunctionSpace):
        self.V = V
        self.Q = Q
        self.mesh = V.mesh

    @property
    def dim(self):
        return self.V.ndof * self.V.value_size + self.Q.ndof

    def zero(self, device):
        import torch

        from ..config import real_dtype

        return (
            torch.zeros((self.V.ndof, self.V.value_size), dtype=real_dtype,
                        device=device),
            torch.zeros((self.Q.ndof,), dtype=real_dtype, device=device),
        )
