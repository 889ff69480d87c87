"""Smoothed-aggregation AMG for the AL velocity block: the ``alamg``,
``simple`` and ``lsc`` modes' velocity solve and the grad-div study's
``amg`` row (the reference's BoomerAMG/ML baselines,
alfi/solver.py:380-384, 423-460), ported from the JAX package's
``mg/amg.py``.

The papers' weak-baseline contrast: an algebraic hierarchy has no access
to the divergence-free near-null space that the star-patch smoother and
the Schoeberl transfer capture, so its iteration counts blow up as gamma
(and Re) grow.

* Host, once per instance (a numpy/scipy copy of the JAX package's):
  scalar-dof aggregation by greedy maximal-independent-set rooting on the
  share-a-cell graph, the componentwise tentative prolongator smoothed by
  one damped Jacobi step of the static symmetric part K + gamma G, and
  deeper levels until the coarse size fits a dense factor; then the
  tables of the device side: P's rows, the rows of P^T, the fine level's
  merged-operator pattern and the level-1 Galerkin product's assembly map.
* Per Newton step: the fine operator's merged values (kernel KA over the
  fine level's pattern, applied by KM), its diagonal read off them, the
  per-cell contributions P_c^T T_c P_c (an einsum, as in the JAX package)
  summed into the dense level-1 matrix by KA over the Galerkin map (no
  atomics: the sums repeat bit for bit), deeper levels as dense products
  and the coarse LU in place.
* Cycle: one V-cycle, Chebyshev-Jacobi smoothing on the fine level, one
  damped-Jacobi sweep on the middle levels, the direct coarse solve.
  Prolongation and restriction are gathers over the rows of P and of P^T.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..kernels import MapAssembly, MergedLevelOperator
from ..solvers.batched_lu import coarse_factor, coarse_solve
from ..solvers.krylov import chebyshev
from ..solvers.linear import vector_rows
from .level_operator import LevelPattern

#: per-cell Galerkin contributions summed by one KA launch: the cells are
#: taken in chunks of at most this many contributions (2 GB of f64), so
#: that the 3D tables (2.3 G contributions for [P1+FB]^3 at 21,771 dofs)
#: stay within int32 map indices and within the card's memory
GALERKIN_CHUNK = 2 ** 28


# ----------------------------------------------------------------------
# host: aggregation + smoothed prolongator chain (the JAX package's
# alfi_tpu/mg/amg.py:42-133, verbatim)
# ----------------------------------------------------------------------
def _scalar_adjacency(cell_dofs, ndof):
    """CSR dof -> neighbour dofs (share a cell), self excluded."""
    from scipy.sparse import coo_matrix

    nc, nl = cell_dofs.shape
    r = np.repeat(cell_dofs, nl, axis=1).reshape(-1)
    c = np.repeat(cell_dofs, nl, axis=0).reshape(-1)
    A = coo_matrix((np.ones(len(r)), (r, c)), shape=(ndof, ndof))
    A = A.tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    return A


def aggregate(adj):
    """Greedy MIS-rooted aggregation (Vanek-style): unaggregated dofs
    with no aggregated neighbours become roots owning their whole
    neighbourhood; leftovers join the smallest adjacent aggregate."""
    ndof = adj.shape[0]
    agg = np.full(ndof, -1, dtype=np.int64)
    nagg = 0
    indptr, indices = adj.indptr, adj.indices
    for i in range(ndof):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if np.any(agg[nbrs] >= 0):
            continue
        agg[i] = nagg
        agg[nbrs] = nagg
        nagg += 1
    # leftovers: join the smallest adjacent aggregate (keeps aggregate
    # sizes balanced under the CSR visit order)
    sizes = np.bincount(agg[agg >= 0], minlength=max(nagg, 1))
    sizes = list(sizes[:nagg])
    for i in range(ndof):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        owned = np.unique(agg[nbrs])
        owned = owned[owned >= 0]
        if len(owned):
            a = int(owned[np.argmin([sizes[j] for j in owned])])
            agg[i] = a
            sizes[a] += 1
        else:
            agg[i] = nagg
            sizes.append(1)
            nagg += 1
    return agg, nagg


def smoothed_prolongator(A_s, agg, nagg, d, omega_scale=4.0 / 3.0):
    """Flat (N, nagg*d) CSR prolongator: componentwise tentative
    aggregates smoothed by one damped-Jacobi step of the flat static
    operator A_s (N = ndof*d)."""
    from scipy.sparse import coo_matrix, diags

    ndof = len(agg)
    N = ndof * d
    rows = np.arange(N)
    cols = agg[rows // d] * d + rows % d
    P0 = coo_matrix((np.ones(N), (rows, cols)),
                    shape=(N, nagg * d)).tocsr()
    dia = A_s.diagonal()
    dia = np.where(dia == 0.0, 1.0, dia)
    Dinv = diags(1.0 / dia)
    DA = Dinv @ A_s
    # rho(D^-1 A) by a few power iterations
    x = np.ones(N) / np.sqrt(N)
    rho = 1.0
    for _ in range(12):
        y = DA @ x
        rho = np.linalg.norm(y)
        x = y / (rho + 1e-300)
    omega = omega_scale / max(rho, 1e-12)
    P = (P0 - omega * (DA @ P0)).tocsr()
    return P


def csr_to_tables(P):
    """CSR (N, n_c) -> padded gather tables (idx (N, kmax), w) with
    zero-weight pads."""
    N = P.shape[0]
    kmax = int(np.diff(P.indptr).max()) if N else 0
    idx = np.zeros((N, max(kmax, 1)), dtype=np.int64)
    w = np.zeros((N, max(kmax, 1)))
    for i in range(N):
        s, e = P.indptr[i], P.indptr[i + 1]
        idx[i, : e - s] = P.indices[s:e]
        w[i, : e - s] = P.data[s:e]
    return idx, w


def galerkin_map(cell_pidx, cell_pw, n1):
    """The level-1 Galerkin product's assembly map: (amap_ptr (n1*n1 + 1,),
    amap_src), a dest-major CSR over the dense (n1, n1) matrix of the
    flat positions c*m*m + i*m + j (m = nld*kmax) in the per-cell
    contributions (nc, m, m) that land on entry (cell_pidx[c, i],
    cell_pidx[c, j]), ascending per entry.  A position with a zero weight
    on either side (a pad or a masked fine row) adds exactly 0 and is
    left out."""
    from scipy.sparse import coo_matrix

    nc, m = cell_pidx.shape
    live = cell_pw != 0.0
    pos = np.flatnonzero((live[:, :, None] & live[:, None, :]).reshape(-1))
    c, ij = np.divmod(pos, m * m)
    i, j = np.divmod(ij, m)
    dest = cell_pidx[c, i] * n1 + cell_pidx[c, j]
    del c, ij, i, j
    # a stable counting sort by destination, in linear time: scipy's COO
    # to CSR keeps each row's entries in their input order
    csr = coo_matrix((np.ones(len(pos), dtype=np.int8),
                      (dest, np.arange(len(pos)))),
                     shape=(n1 * n1, len(pos))).tocsr()
    return csr.indptr, pos[csr.indices]


class VelocityAMG:
    """AMG velocity-block solver with the VelocityMG calling convention
    (setup / make_solve_A), for one solver (supplies form, spaces, BCs,
    gamma, smoothing count, stabilisation, device)."""

    def __init__(self, solver, coarse_max=1500, smoothing=None):
        form = solver.form
        V = solver.Z.V
        self.form = form
        self.device = solver.device
        self.d = d = form.dim
        self.mask_u = solver.bcset.mask[0]
        self.mask_flat = self.mask_u.reshape(-1)
        self.smoothing = smoothing or solver.smoothing
        rows_np = vector_rows(V)
        st = solver.stabilisation
        self.stab = (st if st is not None and st.has_velocity_tensors
                     else None)

        # ---- host: static symmetric part + aggregation chain ----
        from scipy.sparse import coo_matrix, diags

        K, G = form._static_velocity_tensors()
        T_s = K.cpu().numpy() + float(solver.gamma) * G.cpu().numpy()
        N = V.ndof * d
        m = self.mask_flat.cpu().numpy()
        r = np.repeat(rows_np[:, :, None], rows_np.shape[1],
                      axis=2).reshape(-1)
        c = np.repeat(rows_np[:, None, :], rows_np.shape[1],
                      axis=1).reshape(-1)
        A_s = coo_matrix((T_s.reshape(-1) * m[r] * m[c], (r, c)),
                         shape=(N, N)).tocsr()

        cd = V.cell_dofs.astype(np.int64)
        adj = _scalar_adjacency(cd, V.ndof)
        agg, nagg = aggregate(adj)
        P1 = smoothed_prolongator(A_s, agg, nagg, d)
        # zero BC rows of P so corrections never touch constrained dofs
        P1 = (diags(m) @ P1).tocsr()
        self.n1 = P1.shape[1]
        idx, w = csr_to_tables(P1)
        self.kmax = idx.shape[1]

        def dev(a, dtype=torch.int64):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        #: P's rows (prolongation gathers) and P^T's (restriction gathers)
        self.p_idx, self.p_w = dev(idx), dev(w, real_dtype)
        t_idx, t_w = csr_to_tables(P1.T.tocsr())
        self.pt_idx, self.pt_w = dev(t_idx), dev(t_w, real_dtype)

        # the fine operator, merged (KA per set-up, KM per apply)
        self.level_op = MergedLevelOperator(
            LevelPattern(rows_np, N, d, m), device=self.device)
        # per-cell P rows for the Galerkin product, and its assembly maps
        nc = rows_np.shape[0]
        cell_pidx = idx[rows_np].reshape(nc, -1)  # (nc, nld*kmax)
        cell_pw = (w[rows_np] * m[rows_np][..., None]).reshape(nc, -1)
        self.cell_pw = dev(cell_pw, real_dtype)
        per = max(1, GALERKIN_CHUNK // cell_pidx.shape[1] ** 2)
        #: (first cell, end cell, KA over that chunk's Galerkin map): each
        #: gives (n1 * n1,) sums of the chunk's contributions
        self.galerkin = []
        for c0 in range(0, nc, per):
            c1 = min(nc, c0 + per)
            amap_ptr, amap_src = galerkin_map(cell_pidx[c0:c1],
                                              cell_pw[c0:c1], self.n1)
            self.galerkin.append((c0, c1, MapAssembly(
                amap_ptr, amap_src, (c1 - c0) * cell_pidx.shape[1] ** 2,
                device=self.device)))
            del amap_ptr, amap_src

        # deeper levels on the STATIC coarse operator (dense products
        # per step, so just keep the P matrices dense)
        P_deep = []
        A_c = (P1.T @ A_s @ P1).tocsr()
        n = self.n1
        while n > coarse_max:
            adj_c = A_c.copy()
            adj_c.setdiag(0)
            adj_c.eliminate_zeros()
            adj_scalar = abs(adj_c)  # flat graph: aggregate flat dofs
            agg_c, nagg_c = aggregate(adj_scalar.tocsr())
            Pd = smoothed_prolongator(A_c, agg_c, nagg_c, 1)
            P_deep.append(dev(Pd.toarray(), real_dtype))
            A_c = (Pd.T @ A_c @ Pd).tocsr()
            n = A_c.shape[0]
        self.P_deep = P_deep

    # ------------------------------------------------------------------
    def level_apply(self, vals, v):
        """The masked fine velocity operator keep * A (keep * v) + (1 -
        keep) * v on (ndof, d) tensors, one KM call on the merged values
        ``vals`` = setup()["vals"] (no facet-coupled terms: the AMG
        baseline modes never assemble Burman's)."""
        return self.level_op(vals, v.reshape(-1)).reshape(v.shape)

    def _galerkin1(self, tensors):
        """Dense level-1 operator sum_c P_c^T T_c P_c + identity on
        unreached coarse dofs: per chunk of cells the contributions by an
        einsum, summed by KA, the chunks added in order."""
        n1 = self.n1
        nc, nld = tensors.shape[:2]
        Pw = self.cell_pw.reshape(nc, nld, self.kmax)
        A = None
        for c0, c1, ka in self.galerkin:
            contrib = torch.einsum("cia,cij,cjb->ciajb", Pw[c0:c1],
                                   tensors[c0:c1], Pw[c0:c1]).reshape(-1)
            part = ka(contrib)
            del contrib
            A = part if A is None else A.add_(part)
        A = A.reshape(n1, n1)
        dia = A.diagonal()
        dia.add_((dia.abs() < 1e-300).to(A.dtype))
        return A

    def setup(self, u_fine, params, p_fine=None):
        form = self.form
        tensors = form.velocity_element_tensors(params, u_fine)
        if self.stab is not None and p_fine is not None:
            tensors = tensors + params["advect"] * (
                self.stab.velocity_tensors_hook((u_fine, p_fine), params))
        tensors = tensors.contiguous()
        vals = self.level_op.assemble(tensors)
        mats = [self._galerkin1(tensors)]
        for Pd in self.P_deep:
            mats.append(Pd.T @ (mats[-1] @ Pd))
        # the coarsest matrix is read only by its factorisation
        coarse_fac = coarse_factor(mats[-1])
        # fine diagonal for Chebyshev-Jacobi
        diag = self.level_op.diagonal(vals)
        state = {"vals": vals, "mats": mats[:-1],
                 "coarse_fac": coarse_fac, "diag": diag}
        state["lmax"] = self._lmax(state)
        return state

    def _lmax(self, state, iters=10):
        """1.1 x the largest eigenvalue of D^-1 A by 10 power iterations
        from the masked ones vector (a host float)."""
        x = self.mask_u * torch.ones(self.mask_u.shape, dtype=real_dtype,
                                     device=self.device)
        x = x / torch.linalg.norm(x)
        lam = torch.ones((), dtype=real_dtype, device=self.device)
        d2 = state["diag"].reshape(self.mask_u.shape)
        for _ in range(iters):
            y = self.level_apply(state["vals"], x) / d2
            lam = torch.linalg.norm(y)
            x = y / (lam + 1e-300)
        return 1.1 * float(lam)

    def _restrict(self, r):
        """P^T r: fine flat -> level-1, a gather over P^T's rows."""
        return torch.einsum("nk,nk->n", self.pt_w, r.reshape(-1)[self.pt_idx])

    def _prolong(self, xc):
        return torch.einsum("nk,nk->n", self.p_w,
                            xc[self.p_idx]).reshape(self.mask_u.shape)

    def make_solve_A(self, state):
        diag = state["diag"].reshape(self.mask_u.shape)
        mats = state["mats"]
        m = self.smoothing
        vals = state["vals"]

        def smooth(b, x0):
            return chebyshev(lambda v: self.level_apply(vals, v), b,
                             lambda r: r / diag, x0=x0, maxit=m,
                             lmax=state["lmax"])

        def Pd_apply(Pd, r, xc, Amid):
            x = Pd @ xc
            dmid = torch.diagonal(Amid)
            dmid = torch.where(dmid.abs() < 1e-300, 1.0, dmid)
            r2 = r - Amid @ x
            return x + 0.6 * r2 / dmid

        def coarse_chain(r1):
            # middle levels: one damped-Jacobi sweep down, direct at the
            # bottom, sweep back up
            rs = [r1]
            for Pd in self.P_deep:
                rs.append(Pd.T @ rs[-1])
            x = coarse_solve(state["coarse_fac"], rs[-1])
            for i in range(len(self.P_deep) - 1, -1, -1):
                x = Pd_apply(self.P_deep[i], rs[i], x, mats[i])
            return x

        def solve_A(rv):
            x = smooth(rv, torch.zeros_like(rv))
            r = rv - self.level_apply(vals, x)
            xc = coarse_chain(self._restrict(r))
            x = x + self.mask_u * self._prolong(xc)
            return smooth(rv, x)

        return solve_A
