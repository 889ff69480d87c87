"""The hand-written CUDA kernels of the almg cycle, their plain PyTorch
versions, and the launch counts that show a run went through them.

The patch apply runs the fused, masked gather-GEMV-scatter

    out = out_mask * sum_b S_b^T A_b S_b (in_mask * x)
          + (1 - out_mask) * passthrough

with dense f64 blocks A_b (m x m), a 0/1 gather S_b given by an index
table, and 0/1 masks fixed per table (no out_mask: out is the sum).

* K1, the patch apply (smoother and, in f64, Schoeberl patch solves): A_b
  are the explicit patch inverses, the table is ``PatchSet.dofs``.
* K2, the level matvec by blocks: A_b the per-cell element tensors, the
  table ``MGLevel.rows``.  The cycle no longer runs it (see below); it
  stays as the yardstick the merged operator is measured against.

The fused kernel runs in f64 or, for the f32 smoother and cycle
(``alfi_torch/config.py``), in f32: A, x, passthrough and out of one
dtype.

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
(``mg/amg.py``) runs it too, over a map of its own.  KM takes f64 or f32
values and f64 or f32 vectors (the precision modes); in the modes that
store the level operator gamma-split, :class:`GradDivTerm` (kernel KB of
the same source) adds the grad-div term from its f64 factors: its cell
stage in a launch of its own, its dof stage as KM's epilogue on levels
whose KM rows are narrow (``MergedLevelOperator.takes_epilogue``), else
in a second launch.

Where a patch solve runs on f32 factors (the f32 cycle's Schoeberl
transfer; the Chebyshev smoother stored in f32), :class:`PatchLUSolve`
applies the patches' f64 LU factors rounded to f32 by triangular solves
(kernel KL, ``csrc/patch_lu_solve.cu``), as the JAX package applies its
f32 LU factors: an explicit inverse rounded to f32 carries eps32 / nu
into solutions of size 1 / gamma.

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
#: the merged level operator (KM apply, KA assembly, KB grad-div term)
LEVEL_SOURCE = os.path.join(_HERE, "csrc", "level_operator.cu")
#: the gathered batched LU solve of the f32 Schoeberl patches (KL)
LU_SOURCE = os.path.join(_HERE, "csrc", "patch_lu_solve.cu")
SOURCES = (SOURCE, LEVEL_SOURCE, LU_SOURCE)
_BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: the pair kernel takes an even m up to here (csrc: kMaxM)
PAIR_MAX_M = 64
#: strided kernel: columns of a row that a lane loads in one batch, for
#: f64 A (csrc: kSteps); f32 A loads twice as many, the same 32 bytes
STRIDED_STEPS = 4
#: strided kernel: the batches of the LANES_QUANTILE row that the lane
#: rule aims at, for f64 and for f32 A (see strided_lanes_log2)
STRIDED_BATCHES = {8: 2, 4: 4}
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
        lib.alfi_gather_gemv_scatter_f32.restype = ci
        lib.alfi_gather_gemv_scatter_f32.argtypes = (
            lib.alfi_gather_gemv_scatter.argtypes)
    elif source == LU_SOURCE:
        for fn in (lib.alfi_patch_lu_solve, lib.alfi_patch_lu_solve_x64):
            fn.restype = ci
            fn.argtypes = [vp] * 6 + [ci] * 4 + [vp]
        lib.alfi_patch_slot_sum.restype = ci
        lib.alfi_patch_slot_sum.argtypes = [vp] * 6 + [ci] * 3 + [vp]
    else:
        lib.alfi_level_apply.restype = ci
        lib.alfi_level_apply.argtypes = ([vp] * 6 + [ci] * 4 + [vp, ci]
                                         + [vp] * 3)
        lib.alfi_graddiv_apply.restype = ci
        lib.alfi_graddiv_apply.argtypes = ([vp] * 8 + [ci] * 4
                                           + [ctypes.c_double, ci, ci, vp])
        lib.alfi_graddiv_cells.restype = ci
        lib.alfi_graddiv_cells.argtypes = ([vp] * 4 + [ci] * 3
                                           + [ctypes.c_double, ci, ci, vp])
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
    for src in SOURCES:
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
    for src in SOURCES:
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


def strided_lanes_log2(row_extents, itemsize=8):
    """log2 of the strided kernel's lanes per dof for a table whose live
    rows have these extents and A entries of ``itemsize`` bytes: the power
    of two, from 4 lanes (one 32-byte sector per step) to a warp, that
    takes the LANES_QUANTILE row in STRIDED_BATCHES[itemsize] batches of
    32 / itemsize steps: two batches of 4 steps in f64; four of 8 in f32,
    whose rows cost a lane half the bytes, so that more dofs share a warp
    (at the 3D scale row's 4,913 x 189 table 8 lanes where f64 takes 32:
    on the card, 8 lanes ran faster than 16 and 32; PERF.md section 6).
    From the rows and not from m: the largest block of a ragged table
    says little about its rows."""
    if len(row_extents) == 0:
        return 2
    q = float(np.quantile(row_extents, LANES_QUANTILE))
    steps = STRIDED_STEPS * 8 // itemsize
    per_lane = STRIDED_BATCHES[itemsize] * steps
    return int(np.clip(np.ceil(np.log2(max(q / per_lane, 1.0))), 2, 5))


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


#: the floating dtypes the kernels take
FLOATS = (torch.float64, torch.float32)


def _check_tensor(t, name, shape, device, dtypes=(torch.float64,)):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on
    ``device`` with a dtype in ``dtypes``."""
    if t.device != device:
        raise ValueError("%s lies on %s, the table on %s"
                         % (name, t.device, device))
    if t.dtype not in dtypes or t.shape != shape:
        raise ValueError("%s must be %s of shape %s, got %s %s"
                         % (name, " or ".join(str(d) for d in dtypes), shape,
                            t.dtype, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


class GatherGemvScatter:
    """out = out_mask * sum_b S_b^T A_b S_b (in_mask * x)
    + (1 - out_mask) * passthrough, for one fixed index table.

    idx (nb, m) host table of positions in x (pads outside [0, n));
    ``use`` tags the launches ("K1" patch apply, "K2" level matvec by
    blocks); ``in_mask`` / ``out_mask``: optional 0/1 masks of n values,
    fixed here.  With an out_mask every call passes ``passthrough`` (n,).
    The device is the table's: A, x and passthrough must lie on it, all
    f64 or all f32 (out has their dtype).  On a CUDA device the kernel
    takes any m >= 1 (``path`` 0: the pair kernel for an even m <=
    PAIR_MAX_M and an A aligned to two of its entries, else the strided
    one; 1 or 2 force the pair or the strided kernel, for
    measurements)."""

    #: kernel launches per use since the last reset_launch_counts()
    launches = {"K1": 0, "K2": 0}
    #: of those, the f32 launches
    f32_launches = {"K1": 0, "K2": 0}
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
        #: log2 of the strided kernel's lanes per dof, on f64 and on f32 A
        self.lanes_log2 = strided_lanes_log2(slot_cols)
        self.lanes_log2_f32 = strided_lanes_log2(slot_cols, itemsize=4)
        #: the masks as one 0/1 byte (bool) per dof
        self.in_keep = None if in_keep is None else dev(in_keep)
        self.out_keep = None if out_keep is None else dev(out_keep)
        #: this table's kernel launches since the last
        #: reset_launch_counts(), and of those the f32 ones
        self.launched = self.f32_launched = 0
        GatherGemvScatter._tables_alive.add(self)
        self._launch = None
        #: kernel choice on a CUDA device (see the class docstring)
        self.path = 0
        if self.device.type == "cuda":
            lib = load_library()
            self._launch = {torch.float64: lib.alfi_gather_gemv_scatter,
                            torch.float32: lib.alfi_gather_gemv_scatter_f32}
            self._tables = (self.gidx.data_ptr(), self.offsets.data_ptr(),
                            self.slots.data_ptr(),
                            None if self.out_keep is None
                            else self.out_keep.data_ptr(),
                            self.slot_cols.data_ptr())

    def _check(self, t, name, shape, dtype=None):
        _check_tensor(t, name, shape, self.device,
                      FLOATS if dtype is None else (dtype,))

    def __call__(self, A, x, passthrough=None):
        if (passthrough is None) != (self.out_keep is None):
            raise ValueError("passthrough is required exactly when the "
                             "table has an out_mask")
        self._check(A, "A", self.ashape)
        self._check(x, "x", (self.n,), A.dtype)
        if passthrough is not None:
            self._check(passthrough, "passthrough", (self.n,), A.dtype)
        if self._launch is None:
            return self.plain(A, x, passthrough)
        a_ptr = A.data_ptr()
        if self.path == 1 and (a_ptr % (2 * A.element_size()) or self.m % 2
                               or self.m > PAIR_MAX_M):
            raise ValueError("the pair kernel takes an even m <= %d and an "
                             "A aligned to two entries, got m=%d"
                             % (PAIR_MAX_M, self.m))
        out = torch.empty((self.n,), dtype=A.dtype, device=self.device)
        gidx, offsets, slots, out_mask, slot_cols = self._tables
        err = self._launch[A.dtype](
            a_ptr, x.data_ptr(), gidx, offsets, slots, out_mask,
            None if passthrough is None else passthrough.data_ptr(),
            out.data_ptr(), self.n, self.m, self.path, self.device.index,
            torch._C._cuda_getCurrentRawStream(self.device.index),
            slot_cols, self.lanes_log2 if A.dtype == torch.float64
            else self.lanes_log2_f32)
        if err != 0:
            raise RuntimeError("gather_gemv_scatter: CUDA error %d after "
                               "launch" % err)
        GatherGemvScatter.launches[self.use] += 1
        if A.dtype == torch.float32:
            GatherGemvScatter.f32_launches[self.use] += 1
            self.f32_launched += 1
        self.launched += 1
        return out

    def kernel_path(self, path=None):
        """1 (pair) or 2 (strided): the kernel that ``path`` (default:
        this table's) launches on an A aligned to two entries."""
        path = self.path if path is None else path
        if path:
            return path
        return 1 if self.m % 2 == 0 and self.m <= PAIR_MAX_M else 2

    def a_bytes(self, path=None, itemsize=8):
        """(loaded, live): the bytes of A (``itemsize`` bytes an entry)
        that the kernel of ``path`` loads in one call, and the bytes of the
        entries the function needs (row feeds a live output dof, column
        gathers a live dof).  The pair kernel loads every column of a live
        row; the strided kernel the columns below the block's live
        extent."""
        block = self.slots.long() // self.m  # of every live row
        live = int((self.gidx >= 0).sum(1)[block].sum())
        if self.kernel_path(path) == 1:
            return itemsize * self.m * int(block.numel()), itemsize * live
        return itemsize * int(self.slot_cols.sum()), itemsize * live

    def plain(self, A, x, passthrough=None):
        """The same operation in plain PyTorch (torch.where masks, an
        einsum and index_add), on any device, in A's dtype."""
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


_MODE = {(torch.float64, torch.float32): "f64/f32",
         (torch.float32, torch.float64): "f32/f64",
         (torch.float32, torch.float32): "f32/f32"}
_GD_MODES = {**_MODE, (torch.float64, torch.float64): "f64/f64"}


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
    #: of KM's, those in a mixed mode, by "values/vectors" dtype
    mode_launches = {"f64/f32": 0, "f32/f64": 0, "f32/f32": 0}
    #: of KM's, those with KB's dof stage as their epilogue
    epilogue_launches = {"KM+KB": 0}
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
        #: whether a split level apply takes KB's dof stage as KM's
        #: epilogue: on rows of at most 4 d lanes (the 2D levels' 8).  On
        #: wider rows (3D: 16, 32) d lanes would walk the dofs' lists while
        #: the rest of the row's lanes wait; the card measured the epilogue
        #: slower there than a launch of its own (PERF.md section 6)
        self.takes_epilogue = (1 << self.lanes_log2) <= 4 * d
        self._km_launched = 0
        #: this table's KM launches in each mixed mode since the last
        #: reset_launch_counts(), and those with the grad-div epilogue by
        #: "values/vectors" dtype
        self.mode_launched = dict.fromkeys(self.mode_launches, 0)
        self.gd_launched = dict.fromkeys(_GD_MODES.values(), 0)
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

    def __call__(self, vals, x, graddiv=None):
        """out (n,) = keep * A x + (1 - keep) * x, A the merged values;
        ``vals`` and ``x`` each f64 or f32, the arithmetic in the promoted
        dtype, out in x's.  ``graddiv`` = (term, w): a split level apply,
        whose grad-div term (``term``, the level's masked
        :class:`GradDivTerm`, with ``w`` = term.cell_stage(B, gamma, x))
        KM adds as its epilogue: keep * (A x + the term) in one rounding to
        x's dtype."""
        _check_tensor(vals, "vals", self.vshape, self.device, FLOATS)
        _check_tensor(x, "x", (self.n,), self.device, FLOATS)
        if graddiv is not None:
            term, w = graddiv
            term.check_dof_stage(w, self.n)
        if self._lib is None:
            return self.plain(vals, x, graddiv)
        out = torch.empty((self.n,), dtype=x.dtype, device=self.device)
        idx = self.device.index
        gd = ((None, None, None) if graddiv is None
              else (w.data_ptr(), term.offsets.data_ptr(),
                    term.slots.data_ptr()))
        err = self._lib.alfi_level_apply(
            vals.data_ptr(), x.data_ptr(), self.rowptr.data_ptr(),
            self.bcol.data_ptr(), self.keep.data_ptr(), out.data_ptr(),
            self.nodes, self.d, self.lanes_log2, idx,
            torch._C._cuda_getCurrentRawStream(idx),
            int(vals.dtype == torch.float32)
            + 2 * int(x.dtype == torch.float32), *gd)
        if err != 0:
            raise RuntimeError("level_operator KM: CUDA error %d after "
                               "launch" % err)
        MergedLevelOperator.launches["KM"] += 1
        if vals.dtype != torch.float64 or x.dtype != torch.float64:
            mode = _MODE[vals.dtype, x.dtype]
            MergedLevelOperator.mode_launches[mode] += 1
            self.mode_launched[mode] += 1
        if graddiv is not None:
            MergedLevelOperator.epilogue_launches["KM+KB"] += 1
            self.gd_launched[_GD_MODES[vals.dtype, x.dtype]] += 1
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

    def plain(self, vals, x, graddiv=None):
        """KM in plain PyTorch: x gathered by block column, an einsum and
        an index_add_ by block row, then the passthrough; in the promoted
        dtype of vals and x, out in x's.  With ``graddiv``, the term's
        plain dof stage added in f64 to the promoted sum before the one
        rounding."""
        ct = torch.promote_types(vals.dtype, x.dtype)
        xc = x.to(ct)
        xb = xc.reshape(self.nodes, self.d)[self.bcol.long()]
        y = torch.einsum("bij,bj->bi", vals.to(ct), xb)
        acc = xc.new_zeros((self.nodes, self.d)).index_add_(0, self.brow, y)
        acc = acc.reshape(-1)
        if graddiv is not None:
            term, w = graddiv
            acc = acc.to(torch.float64) + term.dof_sums(w)
            xc = x.to(torch.float64)
        return torch.where(self.keep, acc, xc).to(x.dtype)

    def value_bytes(self, itemsize=8):
        """Bytes of one apply's merged operator: the values (``itemsize``
        bytes each) and their block columns."""
        return self.pattern.nnzb * (itemsize * self.d * self.d + 4)


class GradDivTerm:
    """out = y + keep * gamma * sum_c R_c^T B_c (B_c^T R_c (keep * x)):
    the grad-div term of a level operator stored gamma-split, from the
    static per-cell factors B (nc, nld, q) f64 (``NSForm.graddiv_factors``,
    G_c = B_c B_c^T), in f64 arithmetic on x, y and out of one dtype (f64
    or f32): kernel KB of ``csrc/level_operator.cu``, a cell stage and a
    dof stage, no atomics.  Called whole (the raw use), the two stages are
    two launches; a split level apply launches the cell stage alone
    (:meth:`cell_stage`) and KM takes the dof stage as its epilogue
    (:class:`MergedLevelOperator`'s ``graddiv``).

    ``rows`` (nc, nld) host table of each cell's flat dofs; ``keep``: an
    optional 0/1 mask of n values (the level's BC mask, in and out), None
    for the raw operator (the Schoeberl transfer's).  Tensors on the CPU
    run the plain version; on a CUDA device the kernel launches or
    raises."""

    #: calls that launched (a cell stage alone, or both stages) since the
    #: last reset_launch_counts()
    launches = {"KB": 0}
    _tables_alive = weakref.WeakSet()

    def __init__(self, rows, n, *, keep=None, device):
        rows = np.asarray(rows, dtype=np.int64)
        self.nc, self.nld = rows.shape
        self.n = int(n)
        if self.n >= 2 ** 31 or rows.size >= 2 ** 31:
            raise ValueError("table too large for int32 indices")
        live = (rows >= 0) & (rows < self.n)
        if keep is not None:
            kept = _mask_keep(keep, self.n, "keep")
            live &= kept[np.where(live, rows, 0)]
        gidx = np.where(live, rows, -1)
        offsets, slots = csr_from_table(gidx, self.n)

        def dev(a):
            return torch.as_tensor(a, device=device)

        #: the gather table (masked entries -1) and the CSR lists
        self.gidx = dev(gidx.astype(np.int32))
        self.device = self.gidx.device
        self.offsets, self.slots = dev(offsets), dev(slots)
        #: the plain version's table: masked entries point at n (a zero)
        self.pidx = dev(np.where(live, rows, self.n))
        self._scatter = None
        #: this term's launching calls since the last reset_launch_counts(),
        #: and of those the ones on f32 vectors
        self.launched = self.f32_launched = 0
        GradDivTerm._tables_alive.add(self)
        self._lib = None
        if self.device.type == "cuda":
            self._lib = load_library(LEVEL_SOURCE)

    def _check(self, B, x, y=None):
        if B.dim() != 3 or B.shape[:2] != (self.nc, self.nld):
            raise ValueError("B must be (%d, %d, q), got %s"
                             % (self.nc, self.nld, tuple(B.shape)))
        _check_tensor(B, "B", B.shape, self.device)
        _check_tensor(x, "x", (self.n,), self.device, FLOATS)
        if y is not None:
            _check_tensor(y, "y", (self.n,), self.device, (x.dtype,))

    def check_dof_stage(self, w, n):
        """Raise unless w, the cell stage's (nc * nld,) f64 contributions,
        and a vector of n values fit this term (a split level apply's dof
        stage)."""
        if n != self.n:
            raise ValueError("the term has %d values, the operator %d"
                             % (self.n, n))
        _check_tensor(w, "w", (self.nc * self.nld,), self.device)

    def _count(self, x):
        GradDivTerm.launches["KB"] += 1
        self.launched += 1
        if x.dtype == torch.float32:
            self.f32_launched += 1

    def __call__(self, B, gamma, x, y=None, out=None):
        """The term added to ``y`` (None: 0) in ``out`` (None: a new
        tensor; ``out`` may be ``y``), in x's dtype: both stages."""
        self._check(B, x, y)
        if self._lib is None:
            return self.plain(B, gamma, x, y)
        q = B.shape[2]
        if out is None:
            out = torch.empty((self.n,), dtype=x.dtype, device=self.device)
        elif out is not y:
            _check_tensor(out, "out", (self.n,), self.device, (x.dtype,))
        w = torch.empty((self.nc * self.nld,), dtype=torch.float64,
                        device=self.device)
        idx = self.device.index
        err = self._lib.alfi_graddiv_apply(
            B.data_ptr(), x.data_ptr(), self.gidx.data_ptr(),
            self.offsets.data_ptr(), self.slots.data_ptr(),
            None if y is None else y.data_ptr(), out.data_ptr(),
            w.data_ptr(), self.nc, self.nld, q, self.n, float(gamma),
            int(x.dtype == torch.float32), idx,
            torch._C._cuda_getCurrentRawStream(idx))
        if err != 0:
            raise RuntimeError("level_operator KB: CUDA error %d after "
                               "launch" % err)
        self._count(x)
        return out

    def cell_stage(self, B, gamma, x):
        """w (nc * nld,) f64, each cell entry's contribution B_c,i .
        (gamma B_c^T (keep * x)_c), in cell order: the cell stage alone,
        one launch (a split level apply's first)."""
        self._check(B, x)
        if self._lib is None:
            return self.contributions(B, self._plain_cells(B, gamma, x))
        w = torch.empty((self.nc * self.nld,), dtype=torch.float64,
                        device=self.device)
        idx = self.device.index
        err = self._lib.alfi_graddiv_cells(
            B.data_ptr(), x.data_ptr(), self.gidx.data_ptr(), w.data_ptr(),
            self.nc, self.nld, B.shape[2], float(gamma),
            int(x.dtype == torch.float32), idx,
            torch._C._cuda_getCurrentRawStream(idx))
        if err != 0:
            raise RuntimeError("level_operator KB cell stage: CUDA error %d "
                               "after launch" % err)
        self._count(x)
        return w

    def _plain_cells(self, B, gamma, x):
        x64 = x.to(torch.float64)
        vloc = torch.cat([x64, x64.new_zeros(1)])[self.pidx]
        return gamma * torch.einsum("cip,ci->cp", B, vloc)

    def contributions(self, B, dq):
        """(nc * nld,) f64 B_c,i . dq_c of every cell entry (the cell
        stage's second half in plain PyTorch)."""
        return torch.einsum("cip,cp->ci", B, dq).reshape(-1)

    def dof_sums(self, w):
        """(n,) f64 the sum of each dof's live contributions, in ascending
        position: the dof stage in plain PyTorch, the ordered scatter-add
        (``fem/scatter.py:ScatterAdd``)."""
        from .fem.scatter import ScatterAdd

        if self._scatter is None:
            # the live entries only: a scatter table padded to the masked
            # entries' count would hold n times that many slots
            self._live = (self.pidx < self.n).reshape(-1)
            self._scatter = ScatterAdd(self.pidx.reshape(-1)[self._live],
                                       self.n)
        return self._scatter(w[self._live])

    def plain(self, B, gamma, x, y=None):
        """KB in plain PyTorch, f64: the einsum pair and the ordered
        scatter-add; out in x's dtype."""
        acc = self.dof_sums(self.contributions(
            B, self._plain_cells(B, gamma, x)))
        if y is not None:
            acc = y.to(torch.float64) + acc
        return acc.to(x.dtype)


class PatchLUSolve:
    """out = out_mask * sum_p S_p^T (P_p L_p U_p)^{-1} S_p x
    + (1 - out_mask) * passthrough: the additive solve of a patch table
    from the f64 LU factors of its matrices (partial pivoting) stored in
    f32, applied by triangular solves, as the JAX package applies its LU
    factors.  Kernel KL of ``csrc/patch_lu_solve.cu``: gather, row
    interchanges, forward and back substitution, in the factors' f32 (x
    rounded to f32 at the gather).  Patches disjoint in their dofs (the
    Schoeberl transfer's) take one launch and a plain store, 0 at the dofs
    outside them; overlapping ones (the star patches of the
    Chebyshev-driven smoother) store each patch row to f32 scratch and sum
    each dof's rows in x's dtype over its CSR list in a second launch, as
    the JAX package sums its f32 solves in f64.  No atomics.

    ``idx`` (np, m) host table of positions in x (pads outside [0, n));
    ``out_mask`` an optional 0/1 mask of n values, fixed here (with it,
    every call passes ``passthrough``).  :meth:`factor` takes the f64
    matrices (np, m, m) and returns the state each call applies.  x,
    passthrough and out are f32 or f64 (a disjoint table with f32 factors:
    f32).  Tensors on the CPU run the plain version
    (``torch.linalg.lu_solve``); on a CUDA device the kernel launches or
    raises (m <= MAX_M)."""

    #: calls that launched since the last reset_launch_counts() (one or
    #: two kernels each), and of those the ones on f64 vectors
    launches = {"KL": 0}
    mixed_launches = {"KL": 0}
    _tables_alive = weakref.WeakSet()
    #: the kernel's largest patch (csrc: 32 lanes x kMaxRows)
    MAX_M = 128

    def __init__(self, idx, n, *, out_mask=None, device):
        idx = np.asarray(idx, dtype=np.int64)
        nb, m = idx.shape
        n = int(n)
        if n >= 2 ** 31 or idx.size >= 2 ** 31:
            raise ValueError("table too large for int32 tables")
        live = (idx >= 0) & (idx < n)
        flat = idx[live]
        #: disjoint patches store; overlapping ones sum
        self.disjoint = np.unique(flat).size == flat.size
        out_keep = None if out_mask is None else _mask_keep(out_mask, n,
                                                            "out_mask")
        self.n, self.m, self.npatches = n, m, nb
        self.ashape = (nb, m, m)
        #: per patch its live entries (the bound's factor entries: s^2)
        self.sizes = live.sum(axis=1)

        def dev(a):
            return torch.as_tensor(a, device=device)

        gidx = np.where(live, idx, -1)
        #: the gather table's int64 twin (for each factorisation's gperm)
        #: and the plain version's table (pads n)
        self._gidx64 = dev(gidx)
        self.pidx = dev(np.where(live, idx, n))
        self.device = self.pidx.device
        self.out_keep = None if out_keep is None else dev(out_keep)
        if self.disjoint and out_keep is None:
            covered = np.zeros(n, dtype=bool)
            covered[flat] = True
            #: the store table (pads -1) and the dofs outside every patch
            self.sidx = dev(gidx.astype(np.int32))
            self.zero = dev(np.flatnonzero(~covered).astype(np.int32))
        else:
            self.disjoint = False
            # every live row to its scratch slot; the dofs' CSR lists of
            # slots (masked dofs own none)
            self.sidx = dev(np.where(live, np.arange(nb * m).reshape(nb, m),
                                     -1).astype(np.int32))
            self.zero = dev(np.zeros(0, dtype=np.int32))
            owned = gidx if out_keep is None else np.where(
                live & out_keep[np.where(live, idx, 0)], idx, -1)
            offsets, slots = csr_from_table(owned, n)
            self.offsets, self.slots = dev(offsets), dev(slots)
        self.launched = self.mixed_launched = 0
        PatchLUSolve._tables_alive.add(self)
        self._lib = None
        if self.device.type == "cuda":
            if m > self.MAX_M:
                raise ValueError("the LU solve kernel takes m <= %d, got %d"
                                 % (self.MAX_M, m))
            self._lib = load_library(LU_SOURCE)

    def factor(self, A, dtype=torch.float32):
        """The state of one set of patch matrices A (np, m, m) f64: their
        LU factors with partial pivoting, computed in f64
        (``torch.linalg.lu_factor``, a set-up library call) and stored in
        ``dtype`` column-major (``lut``: lut[p, j, i] = LU[p, i, j]), the
        pivots, and the gather table with the row interchanges folded in
        (``gperm``: position in x of row i after them, -1 for a pad)."""
        _check_tensor(A, "A", self.ashape, self.device)
        LU, piv = torch.linalg.lu_factor(A)
        # A = P L U: row i of P^T b is b[perm[i]], perm[i] = the row of
        # P's one in column i
        P, _, _ = torch.lu_unpack(LU, piv, unpack_data=False)
        perm = P.argmax(dim=-2)
        return {"lut": LU.to(dtype).mT.contiguous(),
                "piv": piv,
                "gperm": self._gidx64.gather(1, perm).to(torch.int32)}

    def __call__(self, fac, x, passthrough=None):
        """out (n,) in x's dtype."""
        if (passthrough is None) != (self.out_keep is None):
            raise ValueError("passthrough is required exactly when the "
                             "table has an out_mask")
        lut = fac["lut"]
        _check_tensor(lut, "lut", self.ashape, self.device, FLOATS)
        _check_tensor(x, "x", (self.n,), self.device, FLOATS)
        if passthrough is not None:
            _check_tensor(passthrough, "passthrough", (self.n,), self.device,
                          (x.dtype,))
        if self.disjoint and x.dtype != lut.dtype:
            raise ValueError("a disjoint table stores in the factors' dtype")
        if self._lib is None:
            return self.plain(fac, x, passthrough)
        if lut.dtype != torch.float32:
            raise ValueError("the LU solve kernel takes f32 factors")
        f64 = x.dtype == torch.float64
        solve = (self._lib.alfi_patch_lu_solve_x64 if f64
                 else self._lib.alfi_patch_lu_solve)
        out = torch.empty((self.n,), dtype=x.dtype, device=self.device)
        rows = out if self.disjoint else torch.empty(
            (self.npatches * self.m,), dtype=lut.dtype, device=self.device)
        idx = self.device.index
        stream = torch._C._cuda_getCurrentRawStream(idx)
        err = solve(lut.data_ptr(), x.data_ptr(), fac["gperm"].data_ptr(),
                    self.sidx.data_ptr(), self.zero.data_ptr(),
                    rows.data_ptr(), self.npatches, self.m,
                    int(self.zero.numel()), idx, stream)
        if err == 0 and not self.disjoint:
            err = self._lib.alfi_patch_slot_sum(
                rows.data_ptr(), self.offsets.data_ptr(),
                self.slots.data_ptr(),
                None if self.out_keep is None else self.out_keep.data_ptr(),
                None if passthrough is None else passthrough.data_ptr(),
                out.data_ptr(), self.n, int(not f64), idx, stream)
        if err != 0:
            raise RuntimeError("patch_lu_solve KL: CUDA error %d after "
                               "launch" % err)
        PatchLUSolve.launches["KL"] += 1
        self.launched += 1
        if f64:
            PatchLUSolve.mixed_launches["KL"] += 1
            self.mixed_launched += 1
        return out

    def gathered(self, x):
        """(np, m) x at each patch's dofs, pads 0 (the right-hand sides of
        the plain version)."""
        return torch.cat([x, x.new_zeros(1)])[self.pidx]

    def plain(self, fac, x, passthrough=None):
        """KL in plain PyTorch: the gathered right-hand sides, in the
        factors' dtype, through ``torch.linalg.lu_solve`` on the stored
        factors, then in x's dtype written by the table (disjoint patches;
        pads to a dropped slot) or summed by index_add_, and the
        out-mask."""
        lut = fac["lut"]
        y = torch.linalg.lu_solve(
            lut.mT, fac["piv"],
            self.gathered(x).to(lut.dtype)[..., None])[..., 0].to(x.dtype)
        out = x.new_zeros(self.n + 1)
        if self.disjoint:
            out[self.pidx.reshape(-1)] = y.reshape(-1)
        else:
            out.index_add_(0, self.pidx.reshape(-1), y.reshape(-1))
        out = out[:self.n]
        if self.out_keep is None:
            return out
        return torch.where(self.out_keep, out, passthrough)

    def bound_bytes(self, itemsize=4):
        """{part: bytes} one call must move: the live factor entries (f32),
        the gather and store tables, x at the patches' dofs and out
        (``itemsize`` bytes a value; on overlapping patches x is read and
        out written once a dof, the pass-through included)."""
        live = int(self.sizes.sum())
        return {"factors": 4 * int((self.sizes ** 2).sum()),
                "tables": 2 * 4 * self.npatches * self.m,
                "x": itemsize * live, "out": itemsize * self.n}


def reset_launch_counts():
    """Zero the per-use counts and every live table's own count."""
    for key in GatherGemvScatter.launches:
        GatherGemvScatter.launches[key] = 0
        GatherGemvScatter.f32_launches[key] = 0
    for table in GatherGemvScatter._tables_alive:
        table.launched = table.f32_launched = 0
    for key in MergedLevelOperator.launches:
        MergedLevelOperator.launches[key] = 0
    for key in MergedLevelOperator.mode_launches:
        MergedLevelOperator.mode_launches[key] = 0
    for table in MergedLevelOperator._tables_alive:
        table._km_launched = 0
        table.mode_launched = dict.fromkeys(table.mode_launched, 0)
    for key in MapAssembly.launches:
        MapAssembly.launches[key] = 0
    for table in MapAssembly._tables_alive:
        table.launched = 0
    for table in MergedLevelOperator._tables_alive:
        table.gd_launched = dict.fromkeys(table.gd_launched, 0)
    MergedLevelOperator.epilogue_launches["KM+KB"] = 0
    GradDivTerm.launches["KB"] = 0
    for table in GradDivTerm._tables_alive:
        table.launched = table.f32_launched = 0
    PatchLUSolve.launches["KL"] = 0
    PatchLUSolve.mixed_launches["KL"] = 0
    for table in PatchLUSolve._tables_alive:
        table.launched = table.mixed_launched = 0
