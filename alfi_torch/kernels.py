"""The hand-written CUDA kernels of the almg cycle, their plain PyTorch
versions, and the launch counts that show a run went through them.

The patch apply runs the fused, masked gather-GEMV-scatter

    out = out_mask * sum_b S_b^T A_b S_b (in_mask * x)
          + (1 - out_mask) * passthrough

with dense f64 blocks A_b (m x m), a 0/1 gather S_b given by an index
table, and 0/1 masks fixed per table (no out_mask: out is the sum).

* K1, the patch apply (smoother and Schoeberl patch solves): A_b are the
  explicit patch inverses, the table is ``PatchSet.dofs``.
* K2, the level matvec by blocks: A_b the per-cell element tensors, the
  table ``MGLevel.rows``.  The cycle no longer runs it (see below); it
  stays as the yardstick the merged operator is measured against.

:class:`GatherGemvScatter` binds one table and its masks to the fused
kernel ``csrc/gather_gemv_scatter.cu`` (one launch per apply; its header
note says what bounds it on the card, what the design does about it and
in which order it sums).

The level operator (the cell tensors plus, with Burman's stabilisation,
the interior-facet Jacobians) is applied merged: :class:`MergedLevelOperator`
binds a level's host pattern (``mg/level_operator.py``) to
``csrc/level_operator.cu``, whose KA sums the blocks into one operator of
distinct couplings once per Newton step and whose KM applies it.  KA sums
by a host assembly map alone (:class:`MapAssembly`, a dest-major CSR of
source positions), so the AMG baseline's level-1 Galerkin product
(``mg/amg.py``) runs it too, over a map of its own.

Each source is built with nvcc for ``sm_90a`` at first use, into the
git-ignored ``_build/`` directory under a name keyed by the source's hash,
and bound through ``ctypes`` (a plain C interface).  A table on the CPU
runs the plain version; a table on a CUDA device launches the kernel or
raises.

The 3D tables are ragged: their blocks are padded to the largest one, pads
trailing.  The strided kernel reads, of a live row, only the columns below
the block's live extent (``ncols``), with a number of lanes per dof that
fits the table's rows; both are host tables built here, so that the CPU
tests can hold them to what the kernel is documented to read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import weakref

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
#: the fused gather-GEMV-scatter (K1)
SOURCE = os.path.join(_HERE, "csrc", "gather_gemv_scatter.cu")
#: the merged level operator (KM apply, KA assembly)
LEVEL_SOURCE = os.path.join(_HERE, "csrc", "level_operator.cu")
_BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: the pair kernel takes an even m up to here (csrc: kMaxM)
PAIR_MAX_M = 64
#: strided kernel: columns of a row that a lane loads in one batch (csrc:
#: kSteps)
STRIDED_STEPS = 4
#: strided kernel: the lanes per dof are the power of two (4 .. 32) that
#: takes this quantile of the live rows' extents in two batches
LANES_QUANTILE = 0.75
#: KM: the lanes per node row are the power of two (1 .. 32) that gives
#: the LANES_QUANTILE row about this many bytes of blocks per lane
MERGED_BYTES_PER_LANE = 64

_libs = {}
#: compiler output of the builds that produced the loaded libraries
build_log = ""


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


def library_path(source=SOURCE):
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(_BUILD, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def _bind(source, lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if source == SOURCE:
        lib.alfi_gather_gemv_scatter.restype = ci
        lib.alfi_gather_gemv_scatter.argtypes = ([vp] * 8 + [ci] * 4
                                                 + [vp, vp, ci])
    else:
        lib.alfi_level_apply.restype = ci
        lib.alfi_level_apply.argtypes = [vp] * 6 + [ci] * 4 + [vp]
        lib.alfi_level_assemble.restype = ci
        lib.alfi_level_assemble.argtypes = ([vp, vp, ci, vp, vp, vp,
                                             ctypes.c_longlong, ci, vp])
    return lib


def load_library(source=SOURCE):
    """Build (if needed) and load the kernel library of ``source``;
    returns the ctypes handle.  The first call builds every source that
    is not built yet, one nvcc process per source, all started
    together."""
    global build_log
    if source in _libs:
        return _libs[source]
    procs = {}
    for src in (SOURCE, LEVEL_SOURCE):
        path = library_path(src)
        if src in _libs or os.path.exists(path):
            continue
        os.makedirs(_BUILD, exist_ok=True)
        # private name, then rename: concurrent processes never load a
        # half-written library
        tmp = "%s.tmp%d" % (path, os.getpid())
        procs[src] = (tmp, path, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, path, proc) in procs.items():
        log = proc.communicate()[0]
        build_log += log
        if proc.returncode != 0:
            failed.append("nvcc failed on %s:\n%s" % (src, log))
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    for src in (SOURCE, LEVEL_SOURCE):
        if src not in _libs:
            _libs[src] = _bind(src, ctypes.CDLL(library_path(src)))
    return _libs[source]


def csr_from_table(idx, n):
    """(offsets (n+1,), slots) int32 host arrays: for each k in [0, n),
    the flat positions t of ``idx`` with idx.flat[t] == k, ascending;
    entries outside [0, n) are pads and own nothing."""
    flat = np.asarray(idx, dtype=np.int64).reshape(-1)
    slots = np.flatnonzero((flat >= 0) & (flat < n))
    slots = slots[np.argsort(flat[slots], kind="stable")]
    offsets = np.searchsorted(flat[slots], np.arange(n + 1))
    if offsets[-1] >= 2 ** 31 or flat.size >= 2 ** 31:
        raise ValueError("table too large for int32 CSR lists")
    return offsets.astype(np.int32), slots.astype(np.int32)


def live_extents(gidx):
    """(nb,) int32: per block, one past the last column whose gather
    index is >= 0 (0 for a block that gathers nothing).  A -1 before it
    still reads 0; no column at or past it is read."""
    live = np.asarray(gidx) >= 0
    m = live.shape[1]
    last = m - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last, 0).astype(np.int32)


def strided_lanes_log2(row_extents):
    """log2 of the strided kernel's lanes per dof for a table whose live
    rows have these extents: the power of two, from 4 lanes (one 32-byte
    sector per step) to a warp, that takes the LANES_QUANTILE row in two
    batches of STRIDED_STEPS steps.  From the rows and not from m: the
    largest block of a ragged table says little about its rows."""
    if len(row_extents) == 0:
        return 2
    q = float(np.quantile(row_extents, LANES_QUANTILE))
    return int(np.clip(np.ceil(np.log2(max(q / (2 * STRIDED_STEPS), 1.0))),
                       2, 5))


def _mask_keep(mask, n, name):
    """Host bool (n,) from a 0/1 mask of n values (any shape); raises on
    any other value."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    mask = np.asarray(mask, dtype=np.float64).reshape(-1)
    if mask.shape != (n,):
        raise ValueError("%s has %d values, the table's vector %d"
                         % (name, mask.size, n))
    if not np.all((mask == 0.0) | (mask == 1.0)):
        raise ValueError("%s must hold only 0 and 1" % name)
    return mask == 1.0


def _check_tensor(t, name, shape, device):
    """Raise unless ``t`` is a contiguous f64 tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError("%s lies on %s, the table on %s"
                         % (name, t.device, device))
    if t.dtype != torch.float64 or t.shape != shape:
        raise ValueError("%s must be f64 of shape %s, got %s %s"
                         % (name, shape, t.dtype, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


class GatherGemvScatter:
    """out = out_mask * sum_b S_b^T A_b S_b (in_mask * x)
    + (1 - out_mask) * passthrough, for one fixed index table.

    idx (nb, m) host table of positions in x (pads outside [0, n));
    ``use`` tags the launches ("K1" patch apply, "K2" level matvec by
    blocks); ``in_mask`` / ``out_mask``: optional 0/1 masks of n values,
    fixed here.  With an out_mask every call passes ``passthrough`` (n,).
    The device is the table's: A, x and passthrough must lie on it.  On
    a CUDA device the kernel takes any m >= 1 (``path`` 0: the pair
    kernel for an even m <= PAIR_MAX_M and a 16-byte-aligned A, else the
    strided one; 1 or 2 force the pair or the strided kernel, for
    measurements)."""

    #: kernel launches per use since the last reset_launch_counts()
    launches = {"K1": 0, "K2": 0}
    #: every live table, so that reset_launch_counts() reaches its count
    _tables_alive = weakref.WeakSet()

    def __init__(self, idx, n, use, *, in_mask=None, out_mask=None,
                 device):
        if use not in self.launches:
            raise ValueError("use must be one of %s" % sorted(self.launches))
        idx = np.asarray(idx, dtype=np.int64)
        nb, m = idx.shape
        if m < 1:
            raise ValueError("the table needs m >= 1 columns, got m=%d" % m)
        n = int(n)
        if n >= 2 ** 31:
            raise ValueError("vector too long for int32 tables")
        self.n, self.m, self.use = n, m, use
        self.ashape = (nb, m, m)
        idx = np.where((idx >= 0) & (idx < n), idx, -1)
        in_keep = None if in_mask is None else _mask_keep(in_mask, n,
                                                          "in_mask")
        out_keep = None if out_mask is None else _mask_keep(out_mask, n,
                                                            "out_mask")
        gidx = idx if in_keep is None else np.where(
            (idx >= 0) & in_keep[idx], idx, -1)
        owned = idx if out_keep is None else np.where(
            (idx >= 0) & out_keep[idx], idx, -1)
        offsets, slots = csr_from_table(owned, n)
        ncols = live_extents(gidx)
        slot_cols = ncols[slots // m]  # of every live row's block

        def dev(a):
            return torch.as_tensor(a, device=device)

        #: the table as given, pads pointing at n (the plain version's)
        self.pidx = dev(np.where(idx >= 0, idx, n))
        self.device = self.pidx.device
        #: the kernel's gather table: in-masked entries are pads too
        self.gidx = dev(gidx.astype(np.int32))
        self.offsets, self.slots = dev(offsets), dev(slots)
        #: per block, one past its last gathered column; and the same per
        #: CSR slot (live row), beside ``slots``
        self.ncols, self.slot_cols = dev(ncols), dev(slot_cols)
        #: log2 of the strided kernel's lanes per dof
        self.lanes_log2 = strided_lanes_log2(slot_cols)
        #: the masks as one 0/1 byte (bool) per dof
        self.in_keep = None if in_keep is None else dev(in_keep)
        self.out_keep = None if out_keep is None else dev(out_keep)
        #: this table's kernel launches since the last
        #: reset_launch_counts()
        self.launched = 0
        GatherGemvScatter._tables_alive.add(self)
        self._launch = None
        #: kernel choice on a CUDA device (see the class docstring)
        self.path = 0
        if self.device.type == "cuda":
            self._launch = load_library().alfi_gather_gemv_scatter
            self._tables = (self.gidx.data_ptr(), self.offsets.data_ptr(),
                            self.slots.data_ptr(),
                            None if self.out_keep is None
                            else self.out_keep.data_ptr(),
                            self.slot_cols.data_ptr())

    def _check(self, t, name, shape):
        _check_tensor(t, name, shape, self.device)

    def __call__(self, A, x, passthrough=None):
        if (passthrough is None) != (self.out_keep is None):
            raise ValueError("passthrough is required exactly when the "
                             "table has an out_mask")
        self._check(A, "A", self.ashape)
        self._check(x, "x", (self.n,))
        if passthrough is not None:
            self._check(passthrough, "passthrough", (self.n,))
        if self._launch is None:
            return self.plain(A, x, passthrough)
        a_ptr = A.data_ptr()
        if self.path == 1 and (a_ptr % 16 or self.m % 2
                               or self.m > PAIR_MAX_M):
            raise ValueError("the pair kernel takes an even m <= %d and a "
                             "16-byte-aligned A, got m=%d"
                             % (PAIR_MAX_M, self.m))
        out = torch.empty((self.n,), dtype=torch.float64, device=self.device)
        gidx, offsets, slots, out_mask, slot_cols = self._tables
        err = self._launch(
            a_ptr, x.data_ptr(), gidx, offsets, slots, out_mask,
            None if passthrough is None else passthrough.data_ptr(),
            out.data_ptr(), self.n, self.m, self.path, self.device.index,
            torch._C._cuda_getCurrentRawStream(self.device.index),
            slot_cols, self.lanes_log2)
        if err != 0:
            raise RuntimeError("gather_gemv_scatter: CUDA error %d after "
                               "launch" % err)
        GatherGemvScatter.launches[self.use] += 1
        self.launched += 1
        return out

    def kernel_path(self, path=None):
        """1 (pair) or 2 (strided): the kernel that ``path`` (default:
        this table's) launches on a 16-byte-aligned A."""
        path = self.path if path is None else path
        if path:
            return path
        return 1 if self.m % 2 == 0 and self.m <= PAIR_MAX_M else 2

    def a_bytes(self, path=None):
        """(loaded, live): the bytes of A that the kernel of ``path``
        loads in one call, and the bytes of the entries the function
        needs (row feeds a live output dof, column gathers a live dof).
        The pair kernel loads every column of a live row; the strided
        kernel the columns below the block's live extent."""
        block = self.slots.long() // self.m  # of every live row
        live = int((self.gidx >= 0).sum(1)[block].sum())
        if self.kernel_path(path) == 1:
            return 8 * self.m * int(block.numel()), 8 * live
        return 8 * int(self.slot_cols.sum()), 8 * live

    def plain(self, A, x, passthrough=None):
        """The same operation in plain PyTorch (torch.where masks, an
        einsum and index_add), on any device."""
        n = self.n
        if self.in_keep is not None:
            x = torch.where(self.in_keep, x, 0.0)
        xin = torch.cat([x, x.new_zeros(1)])[self.pidx]
        Y = torch.einsum("bij,bj->bi", A, xin)
        acc = x.new_zeros(n + 1).index_add_(0, self.pidx.reshape(-1),
                                            Y.reshape(-1))[:n]
        if self.out_keep is None:
            return acc
        return torch.where(self.out_keep, acc, passthrough)


class MapAssembly:
    """out[e] = sum of src[amap_src[s]] over s in [amap_ptr[e],
    amap_ptr[e+1]), in that order, with src = [cells flat ‖ facets flat]
    (a position p >= ``ncell`` is entry p - ncell of the facets): kernel
    KA of ``csrc/level_operator.cu``, one thread per entry, no atomics, so
    two launches give the same bits.  An entry with no source is 0.

    ``amap_ptr`` (nvals + 1,), ``amap_src`` host int arrays (int32 on the
    card: raises if a position reaches 2**31).  Each launch adds one to
    ``counts[key]``: by default ``MapAssembly.launches["KG"]``, the maps
    of no merged level operator (the AMG Galerkin product's); a
    MergedLevelOperator counts its own as "KA".  Tensors on the CPU run the
    plain version; on a CUDA device the kernel launches or raises."""

    #: launches since the last reset_launch_counts() of the maps that
    #: count here
    launches = {"KG": 0}
    _tables_alive = weakref.WeakSet()

    def __init__(self, amap_ptr, amap_src, ncell, *, device, counts=None,
                 key="KG"):
        self.counts = MapAssembly.launches if counts is None else counts
        self.key = key
        amap_ptr = np.asarray(amap_ptr, dtype=np.int64)
        amap_src = np.asarray(amap_src, dtype=np.int64)
        if (amap_ptr[-1] >= 2 ** 31 or ncell >= 2 ** 31
                or (amap_src.size and amap_src.max() >= 2 ** 31)):
            raise ValueError("assembly map too large for int32 indices")
        self.ncell = int(ncell)
        self.nvals = len(amap_ptr) - 1
        self.nsrc = int(amap_ptr[-1])
        #: whether the map reads facet sources (positions past ncell)
        self.reads_facets = bool(amap_src.size
                                 and amap_src.max() >= self.ncell)

        def dev(a):
            return torch.as_tensor(a.astype(np.int32), device=device)

        self.amap_ptr, self.amap_src = dev(amap_ptr), dev(amap_src)
        self.device = self.amap_ptr.device
        #: this map's launches since the last reset_launch_counts()
        self.launched = 0
        MapAssembly._tables_alive.add(self)
        self._lib = None
        if self.device.type == "cuda":
            self._lib = load_library(LEVEL_SOURCE)

    def __call__(self, cells, facets=None):
        """(nvals,) sums over the flat ``cells`` (ncell values) and, when
        the map reaches past them, ``facets`` (contiguous f64 on the
        map's device)."""
        for t, name in ((cells, "cells"), (facets, "facets")):
            if t is not None:
                _check_tensor(t, name, t.shape, self.device)
        if cells.numel() != self.ncell:
            raise ValueError("cells has %d values, the map %d"
                             % (cells.numel(), self.ncell))
        if self.reads_facets and facets is None:
            raise ValueError("the map reads facet sources: facets needed")
        if self._lib is None:
            return self.plain(cells, facets)
        vals = torch.empty((self.nvals,), dtype=torch.float64,
                           device=self.device)
        idx = self.device.index
        err = self._lib.alfi_level_assemble(
            cells.data_ptr(), None if facets is None else facets.data_ptr(),
            self.ncell, self.amap_ptr.data_ptr(), self.amap_src.data_ptr(),
            vals.data_ptr(), self.nvals, idx,
            torch._C._cuda_getCurrentRawStream(idx))
        if err != 0:
            raise RuntimeError("level_operator KA: CUDA error %d after "
                               "launch" % err)
        self.counts[self.key] += 1
        self.launched += 1
        return vals

    def plain(self, cells, facets=None):
        """KA in plain PyTorch: the map's sources gathered and added by
        index_add_ in the map's order (deterministic on the CPU only)."""
        src = cells.reshape(-1)
        if facets is not None:
            src = torch.cat([src, facets.reshape(-1)])
        dest = torch.repeat_interleave(
            torch.arange(self.nvals, device=self.device),
            torch.diff(self.amap_ptr.long()))
        return src.new_zeros(self.nvals).index_add_(
            0, dest, src[self.amap_src.long()])


def merged_lanes_log2(row_lengths, d):
    """log2 of KM's lanes per node row for a table of d x d blocks whose
    rows hold these numbers of blocks: the power of two, 1 to a warp,
    that gives the LANES_QUANTILE row at most MERGED_BYTES_PER_LANE bytes
    of blocks per lane.  More lanes per row keep more loads in flight;
    on the card (PERF.md section 6) 64 bytes a lane gave the fastest or
    nearly fastest width at every level table: 8 lanes for the 2D rows of
    9 blocks of 32 bytes, 16 for the 3D step's rows of 12 blocks of 72
    bytes, 32 for the cavity's of about 27."""
    if len(row_lengths) == 0:
        return 0
    q = float(np.quantile(row_lengths, LANES_QUANTILE)) * 8 * d * d
    return int(np.clip(np.ceil(np.log2(max(q / MERGED_BYTES_PER_LANE,
                                           1.0))), 0, 5))


class MergedLevelOperator:
    """The merged level operator of one level (``mg/level_operator.py``
    builds its host ``pattern``, a :class:`LevelPattern`): per Newton
    step :meth:`assemble` (KA) sums the cell tensors and, with Burman's
    stabilisation, the facet tensors into the merged values ``vals``
    (nnzb, d, d); every apply (KM) then computes

        out = keep * A x + (1 - keep) * x

    with the BC mask folded in (masked entries are 0).  Both kernels are
    ``csrc/level_operator.cu`` (its header note says what bounds them and
    in which order they sum).  Tensors on the CPU run the plain versions;
    on a CUDA device the kernels launch or raise."""

    #: kernel launches per kernel since the last reset_launch_counts()
    launches = {"KM": 0, "KA": 0}
    _tables_alive = weakref.WeakSet()

    def __init__(self, pattern, *, device):
        self.pattern = pattern
        d = pattern.d
        self.n, self.d, self.nodes = pattern.n, d, pattern.nodes
        self.vshape = (pattern.nnzb, d, d)
        self.cell_shape, self.facet_shape = (pattern.cell_shape,
                                             pattern.facet_shape)

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.rowptr, self.bcol = dev(pattern.rowptr), dev(pattern.bcol)
        self.device = self.rowptr.device
        #: KA, the assembly by the pattern's map
        self.assembly = MapAssembly(
            pattern.amap_ptr, pattern.amap_src, pattern.ncell, device=device,
            counts=MergedLevelOperator.launches, key="KA")
        #: the mask as one 0/1 byte (bool) per flat dof
        self.keep = dev(pattern.keep)
        brow = np.repeat(np.arange(self.nodes), pattern.row_lengths)
        #: per block, its row node (the plain version's scatter)
        self.brow = dev(brow)
        # per node, its diagonal block (0 for a node with none: all its
        # components are masked)
        diag = np.zeros(self.nodes, dtype=np.int64)
        on_diag = pattern.bcol == brow
        diag[brow[on_diag]] = np.flatnonzero(on_diag)
        self.diag_block = dev(diag)
        #: log2 of KM's lanes per node row
        self.lanes_log2 = merged_lanes_log2(pattern.row_lengths, d)
        self._km_launched = 0
        MergedLevelOperator._tables_alive.add(self)
        self._lib = None
        if self.device.type == "cuda":
            self._lib = load_library(LEVEL_SOURCE)

    def _check(self, t, name, shape):
        _check_tensor(t, name, shape, self.device)

    @property
    def launched(self):
        """This table's launches per kernel since the last
        reset_launch_counts()."""
        return {"KM": self._km_launched, "KA": self.assembly.launched}

    def assemble(self, cells, facets=None):
        """(nnzb, d, d) merged values from the cell tensors (nc, nld, nld)
        and the facet tensors (nf, 2 nld, 2 nld), which are given exactly
        when the pattern has facets."""
        self._check(cells, "cells", self.cell_shape)
        if (facets is None) != (self.facet_shape is None):
            raise ValueError("facet tensors are required exactly when the "
                             "pattern has facets")
        if facets is not None:
            self._check(facets, "facets", self.facet_shape)
        return self.assembly(cells, facets).reshape(self.vshape)

    def __call__(self, vals, x):
        """out (n,) = keep * A x + (1 - keep) * x, A the merged values."""
        self._check(vals, "vals", self.vshape)
        self._check(x, "x", (self.n,))
        if self._lib is None:
            return self.plain(vals, x)
        out = torch.empty((self.n,), dtype=torch.float64, device=self.device)
        idx = self.device.index
        err = self._lib.alfi_level_apply(
            vals.data_ptr(), x.data_ptr(), self.rowptr.data_ptr(),
            self.bcol.data_ptr(), self.keep.data_ptr(), out.data_ptr(),
            self.nodes, self.d, self.lanes_log2, idx,
            torch._C._cuda_getCurrentRawStream(idx))
        if err != 0:
            raise RuntimeError("level_operator KM: CUDA error %d after "
                               "launch" % err)
        MergedLevelOperator.launches["KM"] += 1
        self._km_launched += 1
        return out

    def plain_assemble(self, cells, facets=None):
        """KA's plain version (:meth:`MapAssembly.plain`)."""
        return self.assembly.plain(cells, facets).reshape(self.vshape)

    def diagonal(self, vals):
        """(n,) the operator's diagonal, read off the merged values: the
        diagonal of each node row's diagonal block, 1 on masked dofs (the
        Jacobi smoother's)."""
        ar = torch.arange(self.d, device=self.device)
        dv = vals[self.diag_block][:, ar, ar].reshape(-1)
        return torch.where(self.keep, dv, torch.ones_like(dv))

    def plain(self, vals, x):
        """KM in plain PyTorch: x gathered by block column, an einsum and
        an index_add_ by block row, then the passthrough."""
        xb = x.reshape(self.nodes, self.d)[self.bcol.long()]
        y = torch.einsum("bij,bj->bi", vals, xb)
        acc = x.new_zeros((self.nodes, self.d)).index_add_(0, self.brow, y)
        return torch.where(self.keep, acc.reshape(-1), x)

    def value_bytes(self):
        """Bytes of one apply's merged operator: the values and their
        block columns."""
        return self.pattern.nnzb * (8 * self.d * self.d + 4)


def reset_launch_counts():
    """Zero the per-use counts and every live table's own count."""
    for key in GatherGemvScatter.launches:
        GatherGemvScatter.launches[key] = 0
    for table in GatherGemvScatter._tables_alive:
        table.launched = 0
    for key in MergedLevelOperator.launches:
        MergedLevelOperator.launches[key] = 0
    for table in MergedLevelOperator._tables_alive:
        table._km_launched = 0
    for key in MapAssembly.launches:
        MapAssembly.launches[key] = 0
    for table in MapAssembly._tables_alive:
        table.launched = 0
