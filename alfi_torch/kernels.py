"""Hand-written CUDA kernels of the almg cycle, their plain PyTorch
versions, and the launch counts that show a run went through them.

One operation carries both hot applies of the multigrid cycle: the
batched gather-GEMV-scatter ``y = sum_b S_b^T A_b S_b x`` with dense f64
blocks A_b (m x m) and a 0/1 gather S_b given by an index table.

* K1, the patch apply (smoother and Schoeberl patch solves): A_b are the
  explicit patch inverses, the table is ``PatchSet.dofs``.
* K2, the level matvec: A_b are the per-cell element tensors, the table
  is ``MGLevel.rows``.

It runs as two kernels (``csrc/block_gemv.cu``, whose header note says
what bounds them on the card and what the design does about it):
:func:`gather_bgemv` and :func:`csr_segment_sum`, a deterministic
segment sum over a CSR list built once on the host (no atomics).
:class:`GatherGemvScatter` binds one table to the pair.

The kernels are built with nvcc for ``sm_90a`` at first use, into the
git-ignored ``_build/`` directory under a name keyed by the source's
hash, and bound through ``ctypes`` (a plain C interface).  A wrapper
takes its plain version only for tensors on the CPU; a CUDA tensor gets
the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "block_gemv.cu")
_BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
#: largest block size the gather_bgemv kernel takes
MAX_M = 64

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
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.alfi_gather_bgemv.restype = ctypes.c_int
    lib.alfi_gather_bgemv.argtypes = [vp, vp, vp, vp, ll, ctypes.c_int, ll,
                                      vp]
    lib.alfi_csr_segment_sum.restype = ctypes.c_int
    lib.alfi_csr_segment_sum.argtypes = [vp, vp, vp, vp, ll, vp]
    _lib = lib
    return lib


def _on_cpu(*tensors):
    """True when every tensor lies on the CPU; raises for a mix, and for
    any device other than the CPU and CUDA."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError("kernel inputs must all lie on the CPU or all on one "
                     "CUDA device, got %s" % sorted(str(t.device)
                                                    for t in tensors))


def _check(t, name, dtype, ndim):
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("%s must have %d dims, got shape %s"
                         % (name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _raise_on(err, fn):
    if err != 0:
        raise RuntimeError("%s: CUDA error %d after launch" % (fn, err))


# ----------------------------------------------------------------------
# gather_bgemv
# ----------------------------------------------------------------------
def plain_gather_bgemv(A, x, idx):
    """Plain PyTorch version of :func:`gather_bgemv`."""
    n = x.shape[0]
    idx = idx.long()
    safe = torch.where((idx >= 0) & (idx < n), idx, n)
    xpad = torch.cat([x, x.new_zeros(1)])
    return torch.einsum("bij,bj->bi", A, xpad[safe])


def gather_bgemv(A, x, idx, use):
    """Y (nb, m) with Y[b, i] = sum_j A[b, i, j] * x[idx[b, j]]; an idx
    entry outside [0, len(x)) reads 0.

    A (nb, m, m) f64, x (n,) f64, idx (nb, m) int32, all contiguous;
    m <= 64.  ``use`` ("K1" or "K2") names the launch count to raise."""
    if _on_cpu(A, x, idx):
        return plain_gather_bgemv(A, x, idx)
    _check(A, "A", torch.float64, 3)
    _check(x, "x", torch.float64, 1)
    _check(idx, "idx", torch.int32, 2)
    nb, m, m2 = A.shape
    if m != m2 or tuple(idx.shape) != (nb, m):
        raise ValueError("gather_bgemv: A %s and idx %s do not match"
                         % (tuple(A.shape), tuple(idx.shape)))
    if not 1 <= m <= MAX_M:
        raise ValueError("gather_bgemv takes 1 <= m <= %d, got m=%d"
                         % (MAX_M, m))
    lib = load_library()
    Y = torch.empty((nb, m), dtype=torch.float64, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.alfi_gather_bgemv(A.data_ptr(), x.data_ptr(),
                                    idx.data_ptr(), Y.data_ptr(), nb, m,
                                    x.shape[0], stream)
        gather_bgemv.launches[use] += 1
    _raise_on(err, "gather_bgemv")
    return Y


gather_bgemv.launches = {"K1": 0, "K2": 0}


# ----------------------------------------------------------------------
# csr_segment_sum
# ----------------------------------------------------------------------
def plain_csr_segment_sum(vals, offsets, slots):
    """Plain PyTorch version of :func:`csr_segment_sum`."""
    n = offsets.shape[0] - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(n, device=vals.device), counts)
    out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    return out.index_add(0, seg, vals.reshape(-1)[slots.long()])


def csr_segment_sum(vals, offsets, slots, use):
    """out (n,) with out[k] = sum of vals.flat[slots[t]] for t in
    [offsets[k], offsets[k+1]), added in that order.

    vals f64 contiguous (any shape), offsets (n+1,) and slots int32."""
    if _on_cpu(vals, offsets, slots):
        return plain_csr_segment_sum(vals, offsets, slots)
    if vals.dtype != torch.float64 or not vals.is_contiguous():
        raise TypeError("csr_segment_sum: vals must be contiguous f64")
    _check(offsets, "offsets", torch.int32, 1)
    _check(slots, "slots", torch.int32, 1)
    n = offsets.shape[0] - 1
    lib = load_library()
    out = torch.empty((n,), dtype=torch.float64, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.alfi_csr_segment_sum(vals.data_ptr(), offsets.data_ptr(),
                                       slots.data_ptr(), out.data_ptr(), n,
                                       stream)
        csr_segment_sum.launches[use] += 1
    _raise_on(err, "csr_segment_sum")
    return out


csr_segment_sum.launches = {"K1": 0, "K2": 0}


def reset_launch_counts():
    for fn in (gather_bgemv, csr_segment_sum):
        for key in fn.launches:
            fn.launches[key] = 0


# ----------------------------------------------------------------------
# the shared operation
# ----------------------------------------------------------------------
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


class GatherGemvScatter:
    """y = sum_b S_b^T A_b S_b x for one fixed index table.

    idx (nb, m) host table of positions in x (pads outside [0, n));
    ``use`` tags the launches ("K1" patch apply, "K2" level matvec)."""

    def __init__(self, idx, n, use, *, device):
        idx = np.asarray(idx, dtype=np.int64)
        self.n = int(n)
        self.use = use
        self.idx = torch.as_tensor(idx.astype(np.int32), device=device)
        offsets, slots = csr_from_table(idx, self.n)
        self.offsets = torch.as_tensor(offsets, device=device)
        self.slots = torch.as_tensor(slots, device=device)

    def __call__(self, A, x):
        Y = gather_bgemv(A, x, self.idx, self.use)
        return csr_segment_sum(Y, self.offsets, self.slots, self.use)

    def plain(self, A, x):
        """The same operation through the plain PyTorch versions."""
        Y = plain_gather_bgemv(A, x, self.idx)
        return plain_csr_segment_sum(Y, self.offsets, self.slots)
