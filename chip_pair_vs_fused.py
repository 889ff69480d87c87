#!/usr/bin/env python3
"""Compare alfi_torch's fused gather-GEMV-scatter kernel with the earlier
two-kernel design (``gather_bgemv`` + ``csr_segment_sum``, file
``alfi_torch/csrc/block_gemv.cu`` of commit 84526f7) on one NVIDIA GPU.

    git show 84526f7:alfi_torch/csrc/block_gemv.cu > PAIR.cu
    python3 chip_pair_vs_fused.py PAIR.cu

A record of the comparison made before the pair was deleted; the port
no longer has the pair, and nothing else runs this script.  Both run unmasked on the same inputs (random f64 from
``numpy.random.default_rng(0)``) at the six main-path shapes of the bench
config (ldc2d baseN=16, nref=2: the K1 smoother and Schoeberl patch
tables and the K2 cell tables of levels 2 and 1).  Prints, per shape, the
largest absolute and relative difference of the two outputs and the
median CUDA-event time per call of each (20 back-to-back calls, host
enqueue included), then the largest relative difference over all shapes.
"""

import ctypes
import os
import subprocess
import sys
import tempfile


def _build_pair(src):
    from alfi_torch import kernels

    out = os.path.join(tempfile.mkdtemp(), "libpair.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.alfi_gather_bgemv.restype = ctypes.c_int
    lib.alfi_gather_bgemv.argtypes = [vp, vp, vp, vp, ll, ctypes.c_int, ll,
                                      vp]
    lib.alfi_csr_segment_sum.restype = ctypes.c_int
    lib.alfi_csr_segment_sum.argtypes = [vp, vp, vp, vp, ll, vp]
    return lib


def _median_ms(fn, reps=15, inner=20):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def main(pair_src):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from alfi_torch import ConstantPressureSolver, kernels
    from alfi_torch.problems import TwoDimLidDrivenCavityProblem

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = _build_pair(pair_src)
    dev = torch.device("cuda")
    solver = ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(16), nref=2, k=2, solver_type="almg",
        hierarchy="uniform", gamma=1e4, verbose=False, device=dev)
    vmg = solver.vmg
    ops = [("K1 smoother L%d" % l, vmg.patch_solvers[l - 1][1])
           for l in (2, 1)]
    ops += [("K1 schoeberl L%d" % (t.l + 1), t.papply)
            for t in reversed(vmg.schoeberl)]
    ops += [("K2 level L%d" % l, kernels.GatherGemvScatter(
        vmg.levels[l].rows.cpu().numpy(), vmg.level_ops[l].n, "K2",
        device=dev)) for l in (2, 1)]
    rng = np.random.default_rng(0)
    worst = 0.0
    for name, op in ops:
        nb, m, _ = op.ashape
        n = op.n
        fused = kernels.GatherGemvScatter(op.pidx.cpu().numpy(), n, op.use,
                                          device=dev)
        idx = op.pidx.to(torch.int32)  # pads at n read 0 in both designs
        offsets, slots = fused.offsets, fused.slots
        A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev)
        x = torch.as_tensor(rng.standard_normal(n), device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def pair():
            Y = torch.empty((nb, m), dtype=torch.float64, device=dev)
            out = torch.empty((n,), dtype=torch.float64, device=dev)
            e1 = lib.alfi_gather_bgemv(A.data_ptr(), x.data_ptr(),
                                       idx.data_ptr(), Y.data_ptr(), nb, m,
                                       n, stream)
            e2 = lib.alfi_csr_segment_sum(Y.data_ptr(), offsets.data_ptr(),
                                          slots.data_ptr(), out.data_ptr(),
                                          n, stream)
            if e1 or e2:
                raise RuntimeError("pair launch failed: %d %d" % (e1, e2))
            return out

        yp, yf = pair(), fused(A, x)
        torch.cuda.synchronize()
        diff = float((yp - yf).abs().max())
        rel = diff / float(yp.abs().max())
        worst = max(worst, rel)
        ms_p1 = _median_ms(pair)
        ms_f1 = _median_ms(lambda: fused(A, x))
        ms_f2 = _median_ms(lambda: fused(A, x))
        ms_p2 = _median_ms(pair)
        print("%-17s %6d x %-2d max abs diff %.3e rel %.3e  eager ms: "
              "pair %.4f fused %.4f" % (name, nb, m, diff, rel,
                                        min(ms_p1, ms_p2),
                                        min(ms_f1, ms_f2)), flush=True)
    print("largest relative difference, pair vs fused: %.3e" % worst)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
