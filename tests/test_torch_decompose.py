"""The port's domain decomposition (``alfi_torch/parallel/decompose.py``)
is a numpy copy of the JAX package's: at nb = 8 blocks every table must
equal the JAX module's EXACTLY, each package's functions applied to its
own host objects (whose equality tests/test_torch_host.py holds), for
ldc2d baseN=4 nref=1 on the uniform hierarchy with star patches and for
Scott-Vogelius on the bary hierarchy with macrostar patches: the
partitions (lexsort and recursive bisection), their propagation down the
hierarchy, every ``LevelDecomp`` table, the split smoother and Schoeberl
patch sets and the split prolongations and injections."""

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchCP
from alfi_torch import ScottVogeliusSolver as TorchSV
from alfi_torch.parallel import decompose as tdec
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_tpu import ConstantPressureSolver as JaxCP
from alfi_tpu import ScottVogeliusSolver as JaxSV
from alfi_tpu.parallel import decompose as jdec
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

NB = 8
CONFIGS = {
    "pkp0-uniform-star": (TorchCP, JaxCP, dict(hierarchy="uniform",
                                               patch="star")),
    "sv-bary-macrostar": (TorchSV, JaxSV, dict(hierarchy="bary",
                                               patch="macro")),
}
LEVEL_TABLES = ("cells_pad", "dead", "owned_cell", "dof_block", "gdofs",
                "valid", "lcd", "owner", "lidx", "sslot")
LEVEL_SIZES = ("nb", "mco", "mch", "mc", "L", "ns", "d")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def decomposition(dec, solver, nb=NB):
    """Everything ``dec`` (either package's decompose module) computes for
    ``solver``'s hierarchy, as the distributed solvers call it."""
    mh, vmg = solver.mh, solver.vmg
    base = mh.uniform_meshes[0] if mh.kind == "bary" else mh[0]
    out = {"lex": dec.coarse_partition(base, nb),
           "rcb": dec.rcb_partition(base, nb)}
    blocks, ublocks = dec.propagate_blocks(mh, out["lex"])
    out["blocks"], out["ublocks"] = blocks, ublocks
    local = [[dec.expand_halo(mh[0], blocks[0] == b, 2) for b in range(nb)]]
    for l in range(len(mh) - 1):
        c2f = mh.coarse_to_fine_cells(l)
        nxt = []
        for b in range(nb):
            m = np.zeros(mh[l + 1].num_cells, dtype=bool)
            m[np.unique(c2f[local[l][b]])] = True
            nxt.append(m)
        local.append(nxt)
    out["local"] = local
    levs = []
    for l in range(len(mh)):
        owned = [np.where((blocks[l] == b) & local[l][b])[0]
                 for b in range(nb)]
        halo = [np.where((blocks[l] != b) & local[l][b])[0]
                for b in range(nb)]
        levs.append(dec.LevelDecomp(vmg.levels[l].V, owned, halo, blocks[l]))
    out["levs"] = levs
    out["near"] = [lev.near_owned_dofs(mh[l], 1)
                   for l, lev in enumerate(levs)]
    out["patches"] = []
    for l in range(1, len(mh)):
        mesh_l, ps = mh[l], vmg.patchsets[l - 1]
        vowner = np.full(mesh_l.num_vertices, np.iinfo(np.int64).max,
                         dtype=np.int64)
        np.minimum.at(vowner, mesh_l.cells.ravel().astype(np.int64),
                      np.repeat(np.arange(mesh_l.num_cells, dtype=np.int64),
                                mesh_l.cells.shape[1]))
        seeds = (np.where(mesh_l.macro_vertices)[0] if solver.patch == "macro"
                 else np.arange(mesh_l.num_vertices))
        out["patches"].append(dec.split_patchset(
            ps, blocks[l][vowner[seeds]], levs[l]))
    out["schoeberl"] = [
        dec.split_patchset(vmg.schoeberl[l].patchset,
                           ublocks[l] if mh.kind == "bary" else blocks[l],
                           levs[l + 1])
        for l in range(len(mh) - 1)]
    out["transfers"] = []
    for l in range(len(mh) - 1):
        pro, inj = vmg.prolongs[l], vmg.injects[l]
        out["transfers"].append((
            dec.split_transfer(_np(pro.idx).astype(np.int64), _np(pro.w),
                               levs[l], levs[l + 1], out["near"][l + 1]),
            dec.split_transfer(_np(inj.idx).astype(np.int64), _np(inj.w),
                               levs[l + 1], levs[l], out["near"][l])))
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    torch.set_num_threads(1)
    tcls, jcls, kw = CONFIGS[request.param]
    common = dict(nref=1, k=2, solver_type="almg", gamma=1e4, verbose=False,
                  **kw)
    t = tcls(TorchLDC(4), device="cpu", **common)
    j = jcls(JaxLDC(4), **common)
    return decomposition(tdec, t), decomposition(jdec, j)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    np.testing.assert_array_equal(a, b)


def test_partitions_equal(both):
    t, j = both
    for key in ("lex", "rcb"):
        _equal(t[key], j[key])
    for a, b in zip(t["blocks"] + t["ublocks"], j["blocks"] + j["ublocks"]):
        _equal(a, b)
    for la, lb in zip(t["local"], j["local"]):
        for a, b in zip(la, lb):
            _equal(a, b)


def test_level_decompositions_equal(both):
    t, j = both
    assert len(t["levs"]) == len(j["levs"]) == 2
    for lt, lj in zip(t["levs"], j["levs"]):
        for name in LEVEL_SIZES:
            assert getattr(lt, name) == getattr(lj, name), name
        for name in LEVEL_TABLES:
            _equal(getattr(lt, name), getattr(lj, name))
        for a, b in zip(lt.g2l, lj.g2l):
            _equal(a, b)
        # the per-block localisation helpers
        cells = np.arange(-1, lt.V.mesh.num_cells, 3)
        _equal(lt.localize_cells(cells), lj.localize_cells(cells))
        dofs = np.tile(np.arange(-1, lt.V.ndof, 5), (lt.nb, 1))
        _equal(lt.localize_scalar_dofs(dofs), lj.localize_scalar_dofs(dofs))
    for nt, nj in zip(t["near"], j["near"]):
        for a, b in zip(nt, nj):
            _equal(a, b)


@pytest.mark.parametrize("kind", ["patches", "schoeberl"])
def test_split_patchsets_equal(both, kind):
    t, j = both
    assert len(t[kind]) == len(j[kind]) == 1
    for st, sj in zip(t[kind], j[kind]):
        assert (st["m"], st["npm"]) == (sj["m"], sj["npm"])
        for key in ("pdofs", "pcells", "pl2p", "pactive"):
            _equal(st[key], sj[key])


def test_split_transfers_equal(both):
    t, j = both
    for (pt, it), (pj, ij) in zip(t["transfers"], j["transfers"]):
        for (idx_t, w_t), (idx_j, w_j) in ((pt, pj), (it, ij)):
            _equal(idx_t, idx_j)
            _equal(w_t, w_j)
