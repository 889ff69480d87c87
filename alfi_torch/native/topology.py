"""ctypes loader + numpy fallbacks for the native topology kernels.

The C++ source ``topology.cpp`` beside this file is a byte-for-byte copy
of the JAX package's (``tests/test_torch_host.py`` holds the two equal);
the port reads only its own copy.  It is compiled on
first use (g++ -shared -fPIC -O2) into the port's git-ignored build
directory, under a filename keyed by the SHA-256 of the source, so a
stale binary is never preferred over the checked-in source;
environments without a toolchain silently use the numpy/python
fallbacks (identical results, slower on large meshes)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "topology.cpp")
_BUILD = os.path.normpath(os.path.join(_HERE, "..", "_build"))
_lib = None
_tried = False


def _lib_path():
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"_topology_{h}.so")


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        path = _lib_path()
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            # build to a private name, then rename: concurrent test
            # workers must never load a half-written library
            tmp = "%s.tmp%d" % (path, os.getpid())
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.greedy_color.restype = ctypes.c_int64
        lib.greedy_color.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                     i64p, i64p, i64p, i64p]
        lib.sorted_row_dedup.restype = ctypes.c_int64
        lib.sorted_row_dedup.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                         i64p, i64p, i64p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def have_native():
    return _load() is not None


def _p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def greedy_color(csr_off, csr_vals, ndof, order=None):
    """Distance-coloring of patches by shared dofs.

    csr_off (np+1), csr_vals: per-patch dof lists.  order: optional visit
    order (the relaxation-direction sort).  Returns (colors (np,),
    ncolors)."""
    csr_off = np.ascontiguousarray(csr_off, dtype=np.int64)
    csr_vals = np.ascontiguousarray(csr_vals, dtype=np.int64)
    npat = len(csr_off) - 1
    colors = np.zeros(npat, dtype=np.int64)
    lib = _load()
    if lib is not None:
        order_arr = (np.ascontiguousarray(order, dtype=np.int64)
                     if order is not None else None)
        nc = lib.greedy_color(
            npat, int(ndof), _p(csr_off), _p(csr_vals),
            _p(order_arr) if order_arr is not None else None, _p(colors))
        return colors, int(nc)
    # python fallback
    dof_colors = [[] for _ in range(int(ndof))]
    ncolors = 0
    idx = order if order is not None else range(npat)
    for pp in idx:
        p = int(pp)
        used = set()
        for j in range(csr_off[p], csr_off[p + 1]):
            used.update(dof_colors[csr_vals[j]])
        c = 0
        while c in used:
            c += 1
        ncolors = max(ncolors, c + 1)
        colors[p] = c
        for j in range(csr_off[p], csr_off[p + 1]):
            dof_colors[csr_vals[j]].append(c)
    return colors, ncolors


def sorted_row_dedup(rows):
    """np.unique(rows, axis=0, return_inverse=True) replacement; rows
    must be per-row sorted."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n, w = rows.shape
    lib = _load()
    if lib is None or n == 0:
        uniq, inv = np.unique(rows, axis=0, return_inverse=True)
        return uniq, inv
    inverse = np.zeros(n, dtype=np.int64)
    uniq = np.zeros((n, w), dtype=np.int64)
    nu = lib.sorted_row_dedup(n, w, _p(rows), _p(inverse), _p(uniq))
    return uniq[:nu].copy(), inverse
