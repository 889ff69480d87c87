"""The hand-written CUDA kernel of the almg cycle, its plain PyTorch
version, and the launch counts that show a run went through it.

One operation carries both hot applies of the multigrid cycle, with the
boundary masks folded in:

    out = out_mask * sum_b S_b^T A_b S_b (in_mask * x)
          + (1 - out_mask) * passthrough

with dense f64 blocks A_b (m x m), a 0/1 gather S_b given by an index
table, and 0/1 masks fixed per table (no out_mask: out is the sum).

* K1, the patch apply (smoother and Schoeberl patch solves): A_b are the
  explicit patch inverses, the table is ``PatchSet.dofs``.
* K2, the level matvec: A_b are the per-cell element tensors, the table
  is ``MGLevel.rows``.
* KF, the Burman facet term of the level matvec (Scott-Vogelius): A_b are
  the per-interior-facet Jacobians, the table is the facet rows (both
  cells' dofs, 2 x nld); it adds into K2's output (``out=``).

:class:`GatherGemvScatter` binds one table and its masks to the fused
kernel ``csrc/gather_gemv_scatter.cu`` (one launch per apply; its header
note says what bounds it on the card, what the design does about it and
in which order it sums).  The kernel is built with nvcc for ``sm_90a`` at
first use, into the git-ignored ``_build/`` directory under a name keyed
by the source's hash, and bound through ``ctypes`` (a plain C interface).
A table on the CPU runs the plain version; a table on a CUDA device
launches the kernel or raises.

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
SOURCE = os.path.join(_HERE, "csrc", "gather_gemv_scatter.cu")
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

_lib = None
#: compiler output of the build that produced the loaded library
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


def library_path():
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, "libalfi_kernels_%s.so" % h.hexdigest()[:16])


def load_library():
    """Build (if needed) and load the kernel library; returns the
    ctypes handle."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        # private name, then rename: concurrent processes never load a
        # half-written library
        tmp = "%s.tmp%d" % (path, os.getpid())
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (SOURCE,
                                                           build_log))
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.alfi_gather_gemv_scatter.restype = ci
    lib.alfi_gather_gemv_scatter.argtypes = ([vp] * 8 + [ci] * 4
                                             + [vp, vp, ci, ci])
    _lib = lib
    return lib


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


class GatherGemvScatter:
    """out = out_mask * sum_b S_b^T A_b S_b (in_mask * x)
    + (1 - out_mask) * passthrough, for one fixed index table.

    idx (nb, m) host table of positions in x (pads outside [0, n));
    ``use`` tags the launches ("K1" patch apply, "K2" level matvec, "KF"
    Burman facet term); ``in_mask`` / ``out_mask``: optional 0/1 masks of
    n values, fixed here.  With an out_mask every call passes
    ``passthrough`` (n,), unless it passes ``out`` (n,): then the sum is
    added into ``out`` in place where out_mask is 1 (everywhere without
    one), and ``out`` is returned.
    The device is the table's: A, x and passthrough must lie on it.  On
    a CUDA device the kernel takes any m >= 1 (``path`` 0: the pair
    kernel for an even m <= PAIR_MAX_M and a 16-byte-aligned A, else the
    strided one; 1 or 2 force the pair or the strided kernel, for
    measurements)."""

    #: kernel launches per use since the last reset_launch_counts()
    launches = {"K1": 0, "K2": 0, "KF": 0}
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
        if t.device != self.device:
            raise ValueError("%s lies on %s, the table on %s"
                             % (name, t.device, self.device))
        if t.dtype != torch.float64 or t.shape != shape:
            raise ValueError("%s must be f64 of shape %s, got %s %s"
                             % (name, shape, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)

    def __call__(self, A, x, passthrough=None, *, out=None):
        if out is not None:
            if passthrough is not None:
                raise ValueError("out= takes no passthrough")
            self._check(out, "out", (self.n,))
            if out.data_ptr() == x.data_ptr():
                raise ValueError("out must not be x")
        elif (passthrough is None) != (self.out_keep is None):
            raise ValueError("passthrough is required exactly when the "
                             "table has an out_mask")
        self._check(A, "A", self.ashape)
        self._check(x, "x", (self.n,))
        if passthrough is not None:
            self._check(passthrough, "passthrough", (self.n,))
        if self._launch is None:
            return self.plain(A, x, passthrough, out=out)
        a_ptr = A.data_ptr()
        if self.path == 1 and (a_ptr % 16 or self.m % 2
                               or self.m > PAIR_MAX_M):
            raise ValueError("the pair kernel takes an even m <= %d and a "
                             "16-byte-aligned A, got m=%d"
                             % (PAIR_MAX_M, self.m))
        accumulate = out is not None
        if not accumulate:
            out = torch.empty((self.n,), dtype=torch.float64,
                              device=self.device)
        gidx, offsets, slots, out_mask, slot_cols = self._tables
        err = self._launch(
            a_ptr, x.data_ptr(), gidx, offsets, slots, out_mask,
            None if passthrough is None else passthrough.data_ptr(),
            out.data_ptr(), self.n, self.m, self.path, self.device.index,
            torch._C._cuda_getCurrentRawStream(self.device.index),
            slot_cols, self.lanes_log2, int(accumulate))
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

    def plain(self, A, x, passthrough=None, *, out=None):
        """The same operation in plain PyTorch (torch.where masks, an
        einsum and index_add), on any device; ``out`` as in __call__."""
        n = self.n
        if self.in_keep is not None:
            x = torch.where(self.in_keep, x, 0.0)
        xin = torch.cat([x, x.new_zeros(1)])[self.pidx]
        Y = torch.einsum("bij,bj->bi", A, xin)
        acc = x.new_zeros(n + 1).index_add_(0, self.pidx.reshape(-1),
                                            Y.reshape(-1))[:n]
        if out is not None:
            if self.out_keep is None:
                return out.add_(acc)
            return out.copy_(torch.where(self.out_keep, out + acc, out))
        if self.out_keep is None:
            return acc
        return torch.where(self.out_keep, acc, passthrough)


def reset_launch_counts():
    """Zero the per-use counts and every live table's own count."""
    for key in GatherGemvScatter.launches:
        GatherGemvScatter.launches[key] = 0
    for table in GatherGemvScatter._tables_alive:
        table.launched = 0
