"""The almg Newton step of an existing solver, distributed over the ranks
of a ``torch.distributed`` group: the twin of the JAX package's
``parallel/distributed.py``, one process per rank where the JAX package
runs one ``shard_map`` program.

The reference's MPI execution model (DMPlex overlap partitions,
VecScatter halo exchange, allreduce dots) becomes

* a block decomposition of the mesh hierarchy (``parallel/decompose.py``:
  coarse partition, 2-layer overlap, partitions refined by lineage), of
  which each rank builds only its own block's device arrays;
* per step, rank-local assembly, patch smoother sweeps, Schoeberl
  transfers and Krylov iterations, with
    - interface-packed sums completing the owned-cells-only scatters
      (the VecScatter analogue, :meth:`DistributedSolver._exchange`),
    - owner-weighted inner products (the allreduce analogue,
      ``solvers/krylov.py:ShardDotContext``),
    - the coarse grid's owned cell tensors gathered to every rank and
      solved replicated (the PCTelescope analogue,
      alfi/solver.py:354-377),
  every reduction through ``parallel/sharding.py``, which gives every rank
  the same bits, so that every host decision (the Krylov and Newton
  tests) is the same on every rank.

The computation mirrors the single-device almg step function by function
(the same FGMRES, FMG cycle and patch solves; the level operator by
kernels KA and KM on a pattern of the rank's owned cells, the patch and
Schoeberl solves by kernel K1 on the rank's split patch tables), so the
counts are the single-device solve's and the states agree to summation
order.  It runs eager on the host loop, as the single-device path does.

Ported: ``[Pk]^d``-P0 (``ConstantPressureSolver``) on a uniform hierarchy
with additive star patches and Schoeberl transfers, unstabilised, SUPG or
GLS, in f64.  Scott-Vogelius with macrostar patches and Burman, the
multiplicative sweeps, ``[P1+FB]^3``'s bubble transfer, the precision
modes and ``--rebalance`` are ROADMAP.md Queue 1 item 12b; each raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import real_dtype
from ..fem.scatter import ScatterAdd
from ..kernels import GatherGemvScatter, MergedLevelOperator
from ..mg.level_operator import LevelPattern
from ..mg.patches import (
    contract_patch_tensors,
    patch_static_operators,
    static_patch_sum,
)
from ..solvers.batched_lu import coarse_factor, coarse_solve, patch_inverses
from ..solvers.krylov import ShardDotContext, fgmres
from ..solvers.linear import assemble_dense_from_tensors
from ..stabilisation import ShakibSUPG
from .decompose import (
    LevelDecomp,
    coarse_partition,
    expand_halo,
    propagate_blocks,
    split_patchset,
    split_transfer,
)

_ITEM = "ROADMAP.md Queue 1 item 12b"


class _LocalPatchSet:
    """One rank's rows of a split patch set (``split_patchset``), with the
    interface of a PatchSet that the patch contraction reads: ``cells``
    (np, mcp) local cell slots (pad: the slot count, the zero dump row),
    ``l2p``, ``active``, ``m``."""

    def __init__(self, sp, b, n):
        self.m = sp["m"]
        self.cells = sp["pcells"][b, :n]
        self.l2p = sp["pl2p"][b, :n]
        self.active = sp["pactive"][b, :n]
        #: local flat dofs, pads -1 (kernel K1's table)
        self.dofs = np.where(self.active, sp["pdofs"][b, :n], -1)
        self._contract_cache = {}


class _Level:
    """One level's rank-local tables (local arrays are (L+1, d), row L a
    zero dump row; cell slots (mc,), owned slots first, ``mco`` of them)."""


class DistributedSolver:
    """Distributed execution of an existing almg solver.

    Parameters
    ----------
    solver : NavierStokesSolver with solver_type="almg" (its VelocityMG
        supplies the hierarchy, patch sets, Schoeberl transfers and
        tolerances; this rank localises all of them).
    group : the rank's :class:`~alfi_torch.parallel.sharding.RankGroup`;
        the rank's arrays live on ``group.device``.
    """

    #: cell layers of overlap around each block's coarse cells (the
    #: JAX package's; every patch and transfer row near the owned cells
    #: is then local)
    HALO_LAYERS = 2

    def __init__(self, solver, group):
        if solver.solver_type != "almg":
            raise ValueError("DistributedSolver requires solver_type=almg")
        vmg = solver.vmg
        if solver.patch != "star":
            raise NotImplementedError("distributed macrostar patches: %s"
                                      % _ITEM)
        if solver.patch_composition != "additive":
            raise NotImplementedError("distributed multiplicative sweeps: "
                                      "%s" % _ITEM)
        if any(not hasattr(t, "idx") for t in vmg.prolongs):
            raise NotImplementedError("distributed bubble transfers: %s"
                                      % _ITEM)
        if {vmg.cdt, vmg.sdt, vmg.mdt} != {real_dtype}:
            raise NotImplementedError("distributed precision modes: %s"
                                      % _ITEM)
        self.stab = None
        if solver.stabilisation is not None:
            impl = solver.stabilisation.impl
            if not isinstance(impl, ShakibSUPG) or vmg.stab is None:
                raise NotImplementedError(
                    "distributed %s stabilisation: %s"
                    % (type(impl).__name__, _ITEM))
            #: per-level stabilisations, the single-device PC's
            self.stab = [s.impl for s in vmg.stab]
        if solver.form.wdet.device != group.device:
            raise ValueError("the solver's tensors lie on %s, the rank's "
                             "device is %s" % (solver.form.wdet.device,
                                               group.device))
        self.solver = solver
        self.group = group
        self.rank, self.nb = group.rank, group.size
        self.device = group.device
        self.vmg = vmg
        self.nlevels = vmg.nlevels
        self.d = vmg.d
        mh = solver.mh
        nb = self.nb

        # ---------------- partition + halos (host, every rank) ---------
        block0 = coarse_partition(mh[0], nb)
        blocks, _ = propagate_blocks(mh, block0)
        self.blocks = blocks
        local_sets = [[expand_halo(mh[0], blocks[0] == b, self.HALO_LAYERS)
                       for b in range(nb)]]
        for l in range(self.nlevels - 1):
            c2f = mh.coarse_to_fine_cells(l)
            nxt = []
            for b in range(nb):
                m = np.zeros(mh[l + 1].num_cells, dtype=bool)
                m[np.unique(c2f[local_sets[l][b]])] = True
                nxt.append(m)
            local_sets.append(nxt)
        self.levs = []
        for l in range(self.nlevels):
            owned_cells, halo_cells = [], []
            for b in range(nb):
                owned_cells.append(np.where((blocks[l] == b)
                                            & local_sets[l][b])[0])
                halo_cells.append(np.where((blocks[l] != b)
                                           & local_sets[l][b])[0])
                assert np.all(local_sets[l][b][blocks[l] == b]), (
                    "owned cells must be inside the local set")
            self.levs.append(LevelDecomp(vmg.levels[l].V, owned_cells,
                                         halo_cells, blocks[l]))
        self._build_local_arrays()

    # ------------------------------------------------------------------
    # host: localise every static table of this rank
    # ------------------------------------------------------------------
    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _level(self, l):
        vmg, lev, b, d = self.vmg, self.levs[l], self.rank, self.d
        lv = _Level()
        L, mc, mco = lev.L, lev.mc, lev.mco
        lv.L, lv.mc, lv.mco = L, mc, mco
        cp = lev.cells_pad[b]
        live = cp >= 0
        lv.cells = self._dev(np.clip(cp, 0, None))
        lv.live = self._dev(live)
        lv.owned = self._dev(lev.owned_cell[b])
        lv.lcd = self._dev(lev.lcd[b])
        rows = (lev.lcd[b][:, :, None] * d
                + np.arange(d)[None, None, :]).reshape(mc, -1)
        lv.rows = self._dev(rows)
        n = (L + 1) * d
        lv.n = n
        #: the level's form over the rank's cell slots (a dead slot reads
        #: cell 0's geometry; what it yields is masked)
        form = vmg.levels[l].form
        lv.form = form.restricted(lv.cells, lv.lcd)
        lv.Bt = torch.where(lv.live[:, None, None],
                            lv.form.graddiv_factors(), 0.0)
        valid = lev.valid[b]
        mask_g = vmg.levels[l].mask_u.cpu().numpy()
        mask = np.zeros((L + 1, d))
        mask[:L][valid] = mask_g[lev.gdofs[b][valid]]
        lv.mask = self._dev(mask, real_dtype)
        #: the mask as bool, (L+1, d), True on free dofs
        lv.keep = lv.mask != 0
        lv.ownerw = self._dev(np.concatenate(
            [lev.owner[b], [False]]).astype(np.float64)[:, None],
            real_dtype)
        real = lev.sslot[b] < lev.ns
        lv.ns = lev.ns
        lv.lidx = self._dev(lev.lidx[b][real])
        lv.sslot = self._dev(lev.sslot[b][real])
        #: scatter of all (live) cell slots' rows
        lv.scatter = ScatterAdd(lv.rows, n)
        lv.op = None
        if l > 0:
            # the merged level operator of the rank's OWNED cells (KA, KM)
            lv.op = MergedLevelOperator(LevelPattern(
                rows[:mco], n, d, mask.reshape(-1)), device=self.device)
        return lv

    def _local_patches(self, ps, patch_block, lev):
        sp = split_patchset(ps, patch_block, lev)
        n = int(np.sum(patch_block == self.rank))
        return _LocalPatchSet(sp, self.rank, n)

    def _build_local_arrays(self):
        vmg, solver, mh = self.vmg, self.solver, self.solver.mh
        b, d, nb = self.rank, self.d, self.nb
        self.lv = [self._level(l) for l in range(self.nlevels)]

        # smoother patches (levels 1..): each patch on the block that owns
        # its seed vertex (the block of the vertex's smallest cell)
        self.patches, self.patch_tables, self.patch_static = [], [], []
        for l in range(1, self.nlevels):
            lv, mesh_l = self.lv[l], mh[l]
            vowner = np.full(mesh_l.num_vertices, np.iinfo(np.int64).max,
                             dtype=np.int64)
            np.minimum.at(vowner, mesh_l.cells.ravel().astype(np.int64),
                          np.repeat(np.arange(mesh_l.num_cells,
                                              dtype=np.int64),
                                    mesh_l.cells.shape[1]))
            lps = self._local_patches(vmg.patchsets[l - 1],
                                      self.blocks[l][vowner], self.levs[l])
            self.patches.append(lps)
            self.patch_tables.append(GatherGemvScatter(
                lps.dofs, lv.n, "K1", device=self.device))
            self.patch_static.append(patch_static_operators(lps, lv.form))

        # Schoeberl transfer patches per pair: patch p of the global set is
        # coarse cell p, so it goes to that cell's block
        self.sch_tables, self.sch_static = [], []
        self.zmask = []
        for l in range(self.nlevels - 1):
            tr = vmg.schoeberl[l]
            levf, lvf = self.levs[l + 1], self.lv[l + 1]
            zmask_g = tr.zmask.cpu().numpy()
            zmask = np.zeros((levf.L + 1, d))
            v = levf.valid[b]
            zmask[:levf.L][v] = zmask_g[levf.gdofs[b][v]]
            self.zmask.append(self._dev(zmask, real_dtype))
            lps = self._local_patches(tr.patchset, self.blocks[l], levf)
            self.sch_tables.append(GatherGemvScatter(
                lps.dofs, lvf.n, "K1", device=self.device))
            self.sch_static.append(patch_static_operators(lps, lvf.form))

        # nodal transfers per pair: prolongation (fine <- coarse) and wind
        # injection (coarse <- fine), each exact near the owned cells
        self.pro, self.inj = [], []
        for l in range(self.nlevels - 1):
            levc, levf = self.levs[l], self.levs[l + 1]
            tr = vmg.prolongs[l]
            idx, w = split_transfer(tr.idx.cpu().numpy(), tr.w.cpu().numpy(),
                                    levc, levf,
                                    levf.near_owned_dofs(mh[l + 1], 1))
            self.pro.append(self._transfer(idx[b], w[b], levc.L + 1))
            trj = vmg.injects[l]
            idx, w = split_transfer(trj.idx.cpu().numpy(),
                                    trj.w.cpu().numpy(), levf, levc,
                                    levc.near_owned_dofs(mh[l], 1))
            self.inj.append(self._transfer(idx[b], w[b], levf.L + 1))

        # the fine level's owned cells: the residual, B, B^T, the pressure
        lvf, levf = self.lv[-1], self.levs[-1]
        mco = lvf.mco
        Q = solver.Z.Q
        owned0 = levf.cells_pad[b, :mco]
        live0 = owned0 >= 0
        nlq = Q.cell_dofs.shape[1]
        form = solver.form
        self.fo = form.restricted(lvf.cells[:mco], lvf.lcd[:mco])
        self.live_o = self._dev(live0)
        self.validq = self._dev(np.repeat(live0[:, None], nlq, axis=1))
        self.qweight = self.validq.to(real_dtype)
        self.lcd_o = lvf.lcd[:mco]
        self.scatter_o = ScatterAdd(lvf.rows[:mco], lvf.n)
        qd = np.where(live0[:, None],
                      Q.cell_dofs.astype(np.int64)[np.clip(owned0, 0, None)],
                      -1)
        self.qd = qd
        self.minv = torch.where(self.live_o[:, None, None],
                                self.fo.pressure_mass_inverse(), 0.0)
        mask_p = solver.bcset.mask[1].cpu().numpy()
        self.pmask = self._dev(np.where(live0[:, None],
                                        mask_p[np.clip(qd, 0, None)], 0.0),
                               real_dtype)
        self.q_total = int(Q.ndof)
        self.area = float(solver.area)

        if self.stab is not None:
            # (a) the fine level's cell exchange: halo slots read the P0
            # pressure of their owner (owner slots are the first mco)
            ncells = mh[-1].num_cells
            cnt = np.zeros(ncells, dtype=np.int64)
            for bb in range(nb):
                lc = levf.cells_pad[bb][levf.cells_pad[bb] >= 0]
                cnt[lc] += 1
            shared = np.where(cnt >= 2)[0]
            slot = np.full(ncells, -1, dtype=np.int64)
            slot[shared] = np.arange(len(shared))
            cp = levf.cells_pad[b]
            sl = np.where(cp >= 0, slot[np.clip(cp, 0, None)], -1)
            ii = np.where(sl >= 0)[0]
            self.ncs = len(shared)
            self.cell_lidx = self._dev(ii)
            self.cell_slot = self._dev(sl[ii])
            self.cell_owner = self._dev(ii < levf.mco)
            # (b) the local coarse-to-fine cell maps of the P0 restriction
            # (children of a live local cell are local by construction)
            self.c2f = []
            for l in range(self.nlevels - 1):
                c2f = np.asarray(mh.coarse_to_fine_cells(l))
                levc, levn = self.levs[l], self.levs[l + 1]
                cpc = levc.cells_pad[b]
                livec = cpc >= 0
                c2l = np.full(mh[l + 1].num_cells, levn.mc, dtype=np.int64)
                lv2 = levn.cells_pad[b] >= 0
                c2l[levn.cells_pad[b][lv2]] = np.where(lv2)[0]
                lr = np.full((levc.mc,) + c2f.shape[1:], levn.mc,
                             dtype=np.int64)
                lr[livec] = c2l[c2f[cpc[livec]]]
                assert np.all(lr[livec] < levn.mc), (
                    "children of live local cells must be local")
                self.c2f.append(self._dev(lr))
            self.h = [im.h[self.lv[l].cells] for l, im in
                      enumerate(self.stab)]

        # the coarse grid: this rank's owned live level-0 cells, gathered
        # to every rank; the coarse rhs by owned flat dofs
        lev0 = self.levs[0]
        own0 = lev0.cells_pad[b, :lev0.mco]
        own0_live = own0 >= 0
        self.coarse_slots = self._dev(np.where(own0_live)[0])
        self.coarse_cells = self._dev(own0[own0_live])
        self.nc0 = mh[0].num_cells
        V0 = vmg.levels[0].V
        self.N0d = V0.ndof * d
        v0 = lev0.valid[b]
        gflat = (lev0.gdofs[b][:, None] * d + np.arange(d)[None, :])
        self.coarse_local = self._dev(
            (np.where(v0)[0][:, None] * d + np.arange(d)[None, :]).reshape(-1))
        self.coarse_global = self._dev(gflat[v0].reshape(-1))

    def _transfer(self, idx, w, n_src):
        """(local source rows (Lt, ns), weights, scatter of the adjoint)."""
        idx = self._dev(idx)
        return dict(idx=idx, w=self._dev(w, real_dtype),
                    scatter=ScatterAdd(idx, n_src))

    # ------------------------------------------------------------------
    # device: rank-local building blocks
    # ------------------------------------------------------------------
    def _exchange(self, lv, r):
        """Complete an owned-contributions scatter at the interface dofs by
        one packed sum over the ranks (the VecScatter analogue); (L+1, d)
        or flat."""
        if lv.ns == 0:
            return r
        shape = r.shape
        r = r.reshape(lv.L + 1, self.d)
        buf = r.new_zeros((lv.ns, self.d))
        buf[lv.sslot] = r[lv.lidx]
        tot = self.group.sum_ordered(buf, "exchange")
        r = r.clone()
        r[lv.lidx] = tot[lv.sslot]
        return r.reshape(shape)

    def _exchange_cells(self, pcell):
        """Fill the halo slots of a per-cell array (mc+1,) from their
        owners (one sum: each shared cell has one owner)."""
        if self.ncs == 0:
            return pcell
        buf = pcell.new_zeros((self.ncs,))
        own = self.cell_owner
        buf[self.cell_slot[own]] = pcell[self.cell_lidx[own]]
        buf = self.group.sum_disjoint(buf, "exchange")
        pcell = pcell.clone()
        pcell[self.cell_lidx] = buf[self.cell_slot]
        return pcell

    def _level_matvec(self, l, vals, v):
        """The masked level operator on (L+1, d): KM on the owned cells'
        merged values, the interface sums, then the BC rows."""
        lv = self.lv[l]
        out = self._exchange(lv, lv.op(vals, v.reshape(-1)))
        return torch.where(lv.keep, out.reshape(v.shape), v)

    def _patch_solve(self, table, inv, lv, r):
        """sum_p R_p^T inv_p R_p r (kernel K1 on the rank's patches), with
        the interface sums; r (L+1, d), read only at the patches' dofs."""
        x = table(inv, r.reshape(-1))
        return self._exchange(lv, x).reshape(r.shape)

    def _prolong_std(self, pair, uc):
        uf = torch.einsum("ln,lnd->ld", pair["w"], uc[pair["idx"]])
        return torch.cat([uf, uf.new_zeros((1, uf.shape[1]))])

    def _prolong_std_T(self, pair, lvc, ownerw_f, rf):
        rw = (rf * ownerw_f)[:-1]  # owned fine rows only
        contrib = pair["w"][:, :, None] * rw[:, None, :]
        out = pair["scatter"](contrib.reshape(-1, rf.shape[1]))
        return self._exchange(lvc, out)

    def _inject(self, pair, uf):
        return self._prolong_std(pair, uf)

    def _apply_gd(self, lv, gamma, v):
        """gamma-grad-div action from all live local cells, no exchange:
        exact at every dof whose cells are all local (in particular the
        interior dofs of this rank's Schoeberl patches)."""
        vloc = v.reshape(-1)[lv.rows]
        t = torch.einsum("clq,cl->cq", lv.Bt, vloc)
        rloc = gamma * torch.einsum("clq,cq->cl", lv.Bt, t)
        return lv.scatter(rloc.reshape(-1)).reshape(v.shape)

    def _sch_prolong(self, l, tstate, uc):
        lvf = self.lv[l + 1]
        rhs = self._prolong_std(self.pro[l], uc)
        bb = self.zmask[l] * self._apply_gd(lvf, tstate[l]["gamma"], rhs)
        return rhs - self._patch_solve(self.sch_tables[l], tstate[l]["inv"],
                                       lvf, bb)

    def _sch_restrict(self, l, tstate, rf):
        lvf, lvc = self.lv[l + 1], self.lv[l]
        t = self._patch_solve(self.sch_tables[l], tstate[l]["inv"], lvf,
                              self.zmask[l] * rf)
        bb = self._apply_gd(lvf, tstate[l]["gamma"], t)
        return self._prolong_std_T(self.pro[l], lvc, lvf.ownerw, rf - bb)

    # ------------------------------------------------------------------
    # device: the MG cycle (mirrors mg/velocity.py on local arrays)
    # ------------------------------------------------------------------
    def _mg_setup(self, z, wind, params):
        nl = self.nlevels
        u_fine, p_fine = z
        winds = [None] * nl
        winds[-1] = u_fine
        for l in range(nl - 2, -1, -1):
            winds[l] = self._inject(self.inj[l], winds[l + 1])
        stab = [None] * nl
        if self.stab is not None:
            # the P0 pressure on every local cell slot: owners fill, one
            # cell exchange at the fine level, then the children's means
            lvf = self.lv[-1]
            pcell = u_fine.new_zeros((lvf.mc + 1,))
            pcell[:lvf.mco] = p_fine[:, 0]
            press = [None] * nl
            press[-1] = self._exchange_cells(pcell)
            for l in range(nl - 2, -1, -1):
                pl = press[l + 1][self.c2f[l]].mean(dim=1)
                press[l] = torch.cat([pl, pl.new_zeros((1,))])
            # the frozen (z_last) wind, injected per level like the live one
            fwinds = [None] * nl
            fwinds[-1] = wind
            for l in range(nl - 2, -1, -1):
                fwinds[l] = self._inject(self.inj[l], fwinds[l + 1])
            for l in range(nl):
                lv = self.lv[l]
                stab[l] = (press[l], fwinds[l], self._aux(
                    self.stab[l], fwinds[l][lv.lcd], lv.form.geom.detj,
                    lv.owned))
        nu, gamma, advect = params["nu"], params["gamma"], params["advect"]
        tensors, N_els = [], []
        for l in range(nl):
            lv = self.lv[l]
            form = lv.form
            K_el, G_el = form._static_velocity_tensors()
            N_el = form.advection_element_tensors(winds[l])
            if stab[l] is not None:
                press, fwind, aux = stab[l]
                im = self.stab[l]
                u_loc = winds[l][lv.lcd]
                f = form.forcing(params)
                N_el = N_el + im.velocity_element_tensors_from(
                    params, u_loc, press[:lv.mc, None],
                    (fwind[lv.lcd] if im.mode == "gls"
                     else torch.zeros_like(u_loc)),
                    form.geom.jinv, form.geom.detj, self.h[l], aux,
                    None if f is None else f[0])
            N_el = torch.where(lv.live[:, None, None], N_el, 0.0)
            T = nu * K_el + advect * N_el + gamma * G_el
            tensors.append(torch.where(lv.live[:, None, None], T, 0.0))
            N_els.append(N_el)
        vals = [None] + [
            self.lv[l].op.assemble(tensors[l][:self.lv[l].mco].contiguous())
            for l in range(1, nl)]
        patch_inv = []
        for l in range(1, nl):
            A = static_patch_sum(self.patch_static[l - 1], params)
            A = A + advect * contract_patch_tensors(self.patches[l - 1],
                                                    N_els[l])
            patch_inv.append(patch_inverses(A).contiguous())
        # the coarse grid: every rank's owned level-0 tensors, in the global
        # cell order, assembled and factored on every rank (replicated)
        T0 = tensors[0]
        buf = T0.new_zeros((self.nc0,) + tuple(T0.shape[1:]))
        buf[self.coarse_cells] = T0[self.coarse_slots]
        T0g = self.group.sum_disjoint(buf, "coarse")
        lev0 = self.vmg.levels[0]
        A0 = assemble_dense_from_tensors(lev0.form, T0g, lev0.mask_u)
        return dict(vals=vals, patch_inv=patch_inv,
                    coarse_fac=coarse_factor(A0))

    def _coarse_rhs(self, r):
        """The global coarse right-hand side of the level-0 vector r
        (L0+1, d), the same on every rank: each flat dof from its owner."""
        rw = (r * self.lv[0].ownerw).reshape(-1)
        rg = r.new_zeros((self.N0d,))
        rg[self.coarse_global] = rw[self.coarse_local]
        return self.group.sum_disjoint(rg, "coarse")

    def _coarse_solve(self, state, r):
        lv0 = self.lv[0]
        x = coarse_solve(state["coarse_fac"], self._coarse_rhs(r))
        xl = r.new_zeros(((lv0.L + 1) * self.d,))
        xl[self.coarse_local] = x[self.coarse_global]
        return torch.where(lv0.keep, xl.reshape(r.shape), r)

    def _smooth(self, state, l, b, x0):
        lv = self.lv[l]
        vals = state["vals"][l]
        inv = state["patch_inv"][l - 1]
        table = self.patch_tables[l - 1]

        def pc(r):
            return torch.where(lv.keep, self._patch_solve(table, inv, lv, r),
                               r)

        def A(v):
            return self._level_matvec(l, vals, v)

        m = self.solver.smoothing
        x, _ = fgmres(A, b, pc=pc, x0=x0, rtol=0.0, atol=-1.0, maxit=m,
                      restart=m, ctx=ShardDotContext(lv.ownerw, self.group))
        return x

    def _prolong_mg(self, tstate, l, xc):
        return self.lv[l + 1].mask * self._sch_prolong(l, tstate, xc)

    def _restrict_mg(self, tstate, l, rf):
        if self.vmg.schoeberl_restriction:
            rc = self._sch_restrict(l, tstate, rf)
        else:
            rc = self._prolong_std_T(self.pro[l], self.lv[l],
                                     self.lv[l + 1].ownerw, rf)
        return self.lv[l].mask * rc

    def _vcycle(self, state, tstate, l, b, x0):
        if l == 0:
            return self._coarse_solve(state, b)
        x = self._smooth(state, l, b, x0)
        r = b - self._level_matvec(l, state["vals"][l], x)
        rc = self._restrict_mg(tstate, l - 1, r)
        xc = self._vcycle(state, tstate, l - 1, rc, None)
        x = x + self._prolong_mg(tstate, l - 1, xc)
        return self._smooth(state, l, b, x)

    def _fmg(self, state, tstate, b):
        nl = self.nlevels
        bs = [None] * nl
        bs[-1] = b
        for l in range(nl - 2, -1, -1):
            bs[l] = self._restrict_mg(tstate, l, bs[l + 1])
        x = self._coarse_solve(state, bs[0])
        for l in range(1, nl):
            x = self._prolong_mg(tstate, l - 1, x)
            x = self._vcycle(state, tstate, l, bs[l], x)
        return x

    # ------------------------------------------------------------------
    # device: the mixed residual and the Schur PC on local arrays
    # ------------------------------------------------------------------
    def _aux(self, im, w_loc, detj, owned):
        """A stabilisation's global scalar from the frozen wind's values on
        the rank's cells (Turek's w_avg, its owned part summed over the
        ranks; 0.0 for Shakib)."""
        part = im.aux_partial(w_loc, detj, owned)
        if part is None:
            return 0.0
        return float(self.group.sum_ordered(part)) / im._domain_measure

    def _residual_aux(self, wind):
        """The fine stabilisation's global scalar (0.0 without one)."""
        if self.stab is None:
            return 0.0
        return self._aux(self.stab[-1], wind[self.lcd_o], self.fo.geom.detj,
                         self.live_o)

    def _local_residual(self, z, params, wind, aux):
        """The owned cells' residual (Rv before the interface sums, Rq):
        the function whose jvp is the Jacobian action (the sums are
        linear, so they follow it; ``aux``: :meth:`_residual_aux`)."""
        fo = self.fo
        u, p = z
        u_cells = u[self.lcd_o]
        rv, rq = fo.cell_residual(u_cells, p, params)
        if self.stab is not None:
            # the owned cells' SUPG/GLS residual (the residual hook's:
            # advect-scaled, live-state beta and Lu, frozen GLS wind)
            im = self.stab[-1]
            w_cells = wind[self.lcd_o]
            f = fo.forcing(params)
            rv_s, rq_s = im.residual_local(
                u_cells, p, w_cells, fo.geom.jinv, fo.geom.detj,
                self.h[-1][:self.lv[-1].mco], params, aux,
                None if f is None else f[0])
            rv = rv + params["advect"] * rv_s
            if rq_s is not None:
                rq = rq + params["advect"] * rq_s
        rv = torch.where(self.live_o[:, None, None], rv, 0.0)
        rq = torch.where(self.validq, rq, 0.0)
        Rv = self.scatter_o(rv.reshape(-1)).reshape(u.shape)
        return Rv, rq

    def _residual_masked(self, z, params, wind):
        Rv, Rq = self._local_residual(z, params, wind,
                                      self._residual_aux(wind))
        Rv = self._exchange(self.lv[-1], Rv)
        return (self.lv[-1].mask * Rv, self.pmask * Rq)

    def _apply_divergence(self, t):
        fo = self.fo
        _, gu = fo._vel_fields(t[self.lcd_o])
        divu = torch.diagonal(gu, dim1=-2, dim2=-1).sum(-1)
        rq = -torch.einsum("cq,cq,ql->cl", fo.wdet, divu, fo.tab_q.phi)
        return torch.where(self.validq, rq, 0.0)

    def _apply_pressure_gradient(self, p):
        fo = self.fo
        p_q = torch.einsum("ql,cl->cq", fo.tab_q.phi, p)
        rv = -torch.einsum("cq,cq,cqld->cld", fo.wdet, p_q, fo.gtest)
        rv = torch.where(self.live_o[:, None, None], rv, 0.0)
        lvf = self.lv[-1]
        u = self.scatter_o(rv.reshape(-1)).reshape(lvf.L + 1, self.d)
        return self._exchange(lvf, u)

    def _pressure_mean_project(self, z):
        """Remove the constant-pressure mode (Euclidean, the single-device
        projector's)."""
        u, p = z
        tot = self.group.sum_ordered(torch.sum(torch.where(self.validq, p,
                                                           0.0)))
        return (u, torch.where(self.validq, p - tot / float(self.q_total),
                               0.0))

    def _ctx(self):
        return ShardDotContext((self.lv[-1].ownerw, self.qweight),
                               self.group)

    def _norm(self, v):
        return self._ctx().norm(v)

    def _linear(self, z, F, params, tstate, wind):
        lvf = self.lv[-1]
        tol = self.solver.tolerances
        state = self._mg_setup(z, wind, params)
        mask_u, pmask = lvf.mask, self.pmask
        minvscale = -(params["nu"] + params["gamma"])

        def solve_A(rv):
            return self._fmg(state, tstate, rv)

        def pc(r):
            rv, rq = r
            t = solve_A(mask_u * rv)
            s = rq - self._apply_divergence(t)
            p = minvscale * torch.einsum("clm,cm->cl", self.minv, s)
            w = mask_u * self._apply_pressure_gradient(p)
            return (t - solve_A(w), p)

        def zero(v):
            return (mask_u * v[0], pmask * v[1])

        aux = self._residual_aux(wind)

        def J(v):
            _, Jv = torch.func.jvp(
                lambda zz: self._local_residual(zz, params, wind, aux),
                (z,), (zero(v),))
            Jv_u = self._exchange(lvf, Jv[0])
            return (mask_u * Jv_u + (1.0 - mask_u) * v[0],
                    pmask * Jv[1] + (1.0 - pmask) * v[1])

        project = self._pressure_mean_project if self.solver.nsp else None
        dz, info = fgmres(J, (-F[0], -F[1]), pc=pc, rtol=tol["ksp_rtol"],
                          atol=tol["ksp_atol"], maxit=500, restart=30,
                          project=project, ctx=self._ctx())
        return zero(dz), info["iters"]

    # ------------------------------------------------------------------
    # the public surface (the JAX package's names)
    # ------------------------------------------------------------------
    def transfer_setup(self, params):
        """The Schoeberl patch inverses of the transfer form (nu viscous +
        gamma grad-div, no advection) on this rank's patches: once per
        Reynolds number."""
        return [dict(inv=patch_inverses(static_patch_sum(s, params))
                     .contiguous(), gamma=params["gamma"])
                for s in self.sch_static]

    def _default_wind(self):
        """The frozen wind (the solver's z_last velocity), which only the
        stabilised terms read."""
        if self.stab is None:
            return None
        return self._shard_u(self.solver.z_last[0])

    def _params(self, params):
        params = dict(params)
        params.pop("wind", None)
        return params

    def residual(self, z, params, wind=None):
        """(F, fnorm): the masked residual on this rank's arrays and its
        norm (a float, the same on every rank)."""
        if wind is None:
            wind = self._default_wind()
        F = self._residual_masked(z, self._params(params), wind)
        return F, float(self._norm(F))

    def linear_step(self, z, F, params, tstate, wind=None):
        """(dz, Krylov iterations) of J(z) dz = -F."""
        if wind is None:
            wind = self._default_wind()
        dz, its = self._linear(z, F, self._params(params), tstate, wind)
        return dz, int(its)

    def newton_step(self, z, params, tstate=None, wind=None):
        """One Newton step (residual, almg-FGMRES solve, update), all of it
        distributed; returns (z, Krylov iterations)."""
        if tstate is None:
            tstate = self.transfer_setup(params)
        if wind is None:
            wind = self._default_wind()
        F, _ = self.residual(z, params, wind)
        dz, its = self.linear_step(z, F, params, tstate, wind)
        return (z[0] + dz[0], z[1] + dz[1]), its

    # ---------------- the solver's surface, for run_solver ----------------
    @property
    def Z(self):
        return self.solver.Z

    @property
    def z(self):
        return self.solver.z

    @z.setter
    def z(self, val):
        self.solver.z = val

    @property
    def mesh(self):
        return self.solver.mesh

    @property
    def nref_vis(self):
        return self.solver.nref_vis

    @property
    def residual_no_graddiv(self):
        return self.solver.residual_no_graddiv

    def visprolong(self, u):
        return self.solver.visprolong(u)

    def message(self, msg):
        self.solver.message(msg)

    def barrier(self):
        self.group.barrier()

    def solve(self, re):
        """NavierStokesSolver.solve on this rank's arrays: the same Newton
        rules on norms that are the same on every rank; the solver's state
        is the gathered global one on every rank."""
        return self.solver.solve(re, hooks=self)

    # the hooks of NavierStokesSolver.solve
    def _newton_pieces(self, params):
        params = self._params(params)
        wind = self._default_wind()
        tstate = self.transfer_setup(params)
        params_ngd = dict(params, gamma=0.0)
        return (lambda zz: self._residual_masked(zz, params, wind),
                lambda zz, FF: self._linear(zz, FF, params, tstate, wind),
                lambda zz: self._residual_masked(zz, params_ngd, wind))

    def _solve_norm(self, v):
        return self._norm(v)

    def _shift_pressure(self, z):
        u, p = z
        pint = self._pressure_integral(p)
        return (u, torch.where(self.validq, p - pint / self.area, 0.0))

    def _to_local(self, z):
        return self.shard_state(z)

    def _to_global(self, z):
        return self.gather_state(z)

    def _pressure_integral(self, p):
        fo = self.fo
        tq = fo.tab_q
        p_q = torch.einsum("ql,cl->cq", tq.phi, p)
        loc = torch.einsum("q,c,cq->", tq.w,
                           torch.where(self.live_o, fo.geom.detj, 0.0), p_q)
        return float(self.group.sum_ordered(loc))

    # ---------------- state movement ----------------
    def _shard_u(self, u):
        """Global (ndofV, d) velocity -> this rank's (L+1, d)."""
        levf, b = self.levs[-1], self.rank
        v = levf.valid[b]
        rows = self._dev(levf.gdofs[b][v])
        ub = torch.zeros((levf.L + 1, self.d), dtype=real_dtype,
                         device=self.device)
        ub[self._dev(np.where(v)[0])] = u[rows]
        return ub

    def shard_state(self, z, params=None):
        """Global (u, p) -> this rank's (u (L+1, d), p (mco, nlq)); with
        ``params``, (that, params)."""
        p = z[1]
        live = self.qd >= 0
        pb = torch.where(self._dev(live),
                         p[self._dev(np.clip(self.qd, 0, None))], 0.0)
        zs = (self._shard_u(z[0]), pb)
        return zs if params is None else (zs, self._params(params))

    def gather_state(self, z):
        """This rank's arrays -> the global (u, p), the same on every rank
        (each dof written by its owner alone, then one sum)."""
        levf, b = self.levs[-1], self.rank
        own = levf.owner[b]
        ub, pb = z
        V, Q = self.solver.Z.V, self.solver.Z.Q
        u = ub.new_zeros((V.ndof, self.d))
        u[self._dev(levf.gdofs[b][own])] = ub[self._dev(np.where(own)[0])]
        live = self.qd >= 0
        p = pb.new_zeros((Q.ndof,))
        p[self._dev(self.qd[live])] = pb[self._dev(live)]
        return self.group.sum_disjoint(u), self.group.sum_disjoint(p)
