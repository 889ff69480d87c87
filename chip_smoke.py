#!/usr/bin/env python3
"""Smoke test of the alfi_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``alfi_torch/csrc`` and print the seconds;
3. hold each kernel against its plain PyTorch version on the card, on the
   index tables of the bench config's main path with random f64 inputs
   from ``numpy.random.default_rng(0)``: max relative error <= 1e-13;
   print median CUDA-event times of kernel and plain version;
4. the port's reference parity: the small config (ldc2d baseN=4 nref=1)
   must take the JAX package's Krylov/Newton counts 8/2, 7/2, 15/3 over
   Re 1/10/100;
5. the bench config (ldc2d [P2]^2-P0 almg, baseN=16, nref=2, 41,474
   dofs, the configuration of ``bench.py``): warm up with Re=1, reset the
   state, time Re 1 -> 10 -> 100; every Re must converge with 7 Newton
   steps and 22 +- 2 Krylov iterations in all, and the main path must
   have launched both kernels in both of their uses; then one Newton
   linear step is traced with torch.profiler (device busy share, kernel
   time by name);
6. the same problem at nref=3 (164,866 dofs) for Re 1 -> 10 must
   converge;

then print the kernel table as one JSON line and, last, the result line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
CUDA is unavailable or the ``alfi_torch`` package is not beside this
file.
"""

import json
import os
import subprocess
import sys
import time

BENCH_RES = [1, 10, 100]
SMALL_COUNTS = [(8, 2), (7, 2), (15, 3)]  # JAX package, CPU f64
REL_TOL = 1e-13
PALLAS_GEMV = ("alfi_tpu/solvers/patch_pallas.py:46 _gemv_kernel "
               "(deleted in aaee1ce; git show "
               "aaee1ce^:alfi_tpu/solvers/patch_pallas.py)")
XLA_LEVEL_APPLY = ("alfi_tpu/mg/velocity.py:437 (plain-XLA batch-major "
                   "level_apply; no Pallas kernel)")


def _median_ms(fn, reps=15, inner=20):
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call (ms): what a call costs in the eager loop, host
    enqueue included."""
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


def _device_kernels(prof):
    """(name, device us) of every kernel a torch.profiler run saw."""
    import torch

    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_ms(fn, reps=20):
    """Device time per call (ms) summed over every kernel ``fn`` runs,
    from a torch.profiler trace; None when the trace shows no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(us for _, us in _device_kernels(prof))
    return total / reps / 1e3 if total > 0 else None


def _compare(name, kernel, plain):
    """Kernel vs plain version on the same inputs: max abs/rel error and
    the times of both, taken in turns (plain, kernel, kernel, plain)."""
    import torch

    yk, yp = kernel(), plain()
    torch.cuda.synchronize()
    abs_err = float((yk - yp).abs().max())
    rel_err = abs_err / max(float(yp.abs().max()), 1e-300)
    if not rel_err <= REL_TOL:
        raise AssertionError("%s: kernel vs plain max rel err %.3e > %.0e"
                             % (name, rel_err, REL_TOL))
    ms_p1 = _median_ms(plain)
    ms_k1 = _median_ms(kernel)
    ms_k2 = _median_ms(kernel)
    ms_p2 = _median_ms(plain)
    return {"abs_err": abs_err, "rel_err": rel_err,
            "ms": min(ms_k1, ms_k2), "plain_ms": min(ms_p1, ms_p2),
            "dev_ms": _device_ms(kernel), "plain_dev_ms": _device_ms(plain)}


def _fmt(ms):
    return "not measured" if ms is None else "%.4f" % ms


def _solve_sweep(solver, res):
    import torch

    rows, t_all = [], 0.0
    for re in res:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, info = solver.solve(re)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t_all += dt
        finite = all(bool(torch.isfinite(x).all()) for x in z)
        rows.append((re, info["linear_iter"], info["nonlinear_iter"], dt,
                     solver.residual_no_graddiv))
        print("  Re=%-4s krylov=%-3d newton=%d  %.3f s  gamma-free "
              "residual %.3e" % rows[-1], flush=True)
        if not (info["converged"] and finite):
            raise AssertionError("Re=%s did not converge (finite=%s)"
                                 % (re, finite))
    return rows, t_all


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from alfi_torch import ConstantPressureSolver, kernels
    from alfi_torch.problems import TwoDimLidDrivenCavityProblem

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    # 2. build
    t0 = time.perf_counter()
    kernels.load_library()
    print("kernel build: %.2f s" % (time.perf_counter() - t0), flush=True)
    for line in kernels.build_log.splitlines():
        if "ptxas info" in line:
            print("  " + line.strip())

    # 3. kernels vs plain versions on the main path's tables
    def make(baseN, nref):
        return ConstantPressureSolver(
            TwoDimLidDrivenCavityProblem(baseN), nref=nref, k=2,
            solver_type="almg", hierarchy="uniform", gamma=1e4,
            verbose=False, device=dev)

    t0 = time.perf_counter()
    bench = make(16, 2)
    print("bench solver built: %d dofs, %.2f s"
          % (bench.Z.dim, time.perf_counter() - t0), flush=True)
    vmg = bench.vmg
    ops = [("K1 smoother L%d" % l, vmg.patch_solvers[l - 1][1])
           for l in (2, 1)]
    ops += [("K1 schoeberl L%d" % (t.l + 1), t.papply)
            for t in reversed(vmg.schoeberl)]
    ops += [("K2 level L%d" % l, vmg.levels[l].matvec) for l in (2, 1)]
    rng = np.random.default_rng(0)
    table = {}
    print("%-18s %11s %9s  %s" % (
        "operator", "blocks x m", "rel err",
        "ms per call, eager (device only): kernel | plain"))
    for name, op in ops:
        nb, m = op.idx.shape
        A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev)
        x = torch.as_tensor(rng.standard_normal(op.n), device=dev)
        Y = kernels.gather_bgemv(A, x, op.idx, op.use)
        res = {
            "op": _compare(name, lambda: op(A, x), lambda: op.plain(A, x)),
            "gather_bgemv": _compare(
                name + " gather_bgemv",
                lambda: kernels.gather_bgemv(A, x, op.idx, op.use),
                lambda: kernels.plain_gather_bgemv(A, x, op.idx)),
            "csr_segment_sum": _compare(
                name + " csr_segment_sum",
                lambda: kernels.csr_segment_sum(Y, op.offsets, op.slots,
                                                op.use),
                lambda: kernels.plain_csr_segment_sum(Y, op.offsets,
                                                      op.slots)),
        }
        table[name] = res
        for part in ("op", "gather_bgemv", "csr_segment_sum"):
            r = res[part]
            print("%-18s %6d x %-2d %9.2e  %s (%s) | %s (%s)  [%s]" % (
                name, nb, m, r["rel_err"], _fmt(r["ms"]), _fmt(r["dev_ms"]),
                _fmt(r["plain_ms"]), _fmt(r["plain_dev_ms"]), part),
                flush=True)

    # 4. reference parity at the small config
    small = make(4, 1)
    rows, _ = _solve_sweep(small, BENCH_RES)
    counts = [(r[1], r[2]) for r in rows]
    if counts != SMALL_COUNTS:
        raise AssertionError("small config counts %s != JAX package %s"
                             % (counts, SMALL_COUNTS))
    print("small config (%d dofs) counts equal the JAX package's: %s"
          % (small.Z.dim, counts), flush=True)

    # 5. the bench config
    t0 = time.perf_counter()
    bench.solve(1)
    torch.cuda.synchronize()
    print("warm-up Re=1: %.3f s" % (time.perf_counter() - t0), flush=True)
    bench.z = bench.bcset.apply(bench.Z.zero(dev))
    bench.z_last = bench.z
    kernels.reset_launch_counts()
    rows, t_bench = _solve_sweep(bench, BENCH_RES)
    launches = {fn.__name__: dict(fn.launches)
                for fn in (kernels.gather_bgemv, kernels.csr_segment_sum)}
    krylov = sum(r[1] for r in rows)
    newton = sum(r[2] for r in rows)
    print("bench config: %d dofs, Re 1->10->100 in %.3f s, Krylov %d, "
          "Newton %d, launches %s" % (bench.Z.dim, t_bench, krylov, newton,
                                      launches), flush=True)
    if newton != 7 or abs(krylov - 22) > 2:
        raise AssertionError("bench counts %d/%d, expected 22+-2 / 7"
                             % (krylov, newton))
    for fn_name, per_use in launches.items():
        for use in ("K1", "K2"):
            if per_use[use] <= 0:
                raise AssertionError("%s was not launched for %s on the "
                                     "main path" % (fn_name, use))

    # where the time goes: one Newton linear step of the Re=100 solve
    # (from the Re=10 state) under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    params = bench.params()
    z = bench.z_last
    F = bench.residual_masked(z, params)
    tstate = bench._transfer_setup(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, its = bench._linear_step(z, F, params, tstate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = _device_kernels(prof)
    busy = sum(us for _, us in kern) / 1e6
    print("profiled linear step: %d Krylov its, %.3f s wall (profiler on), "
          "%d kernels, device busy %.3f s = %.1f%% of wall"
          % (its, wall, len(kern), busy, 100.0 * busy / wall), flush=True)
    by_name = {}
    for kname, us in kern:
        n_us = by_name.setdefault(kname[:70], [0, 0.0])
        n_us[0] += 1
        n_us[1] += us
    for kname, (cnt, us) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:10]:
        print("  %8.2f ms %6d x  %s" % (us / 1e3, cnt, kname))
    # the Jacobian action is torch.func.jvp of the residual, which
    # evaluates the residual again on every call
    from alfi_torch.solvers.linear import make_jacobian_matvec

    J = make_jacobian_matvec(bench.form.residual, bench.bcset, z, params)
    ms_res = _median_ms(lambda: bench.residual_masked(z, params), reps=5,
                        inner=10)
    ms_jvp = _median_ms(lambda: J(F), reps=5, inner=10)
    print("Jacobian action (jvp): %.3f ms per call; masked residual: "
          "%.3f ms per call" % (ms_jvp, ms_res), flush=True)

    # 6. nref=3
    t0 = time.perf_counter()
    big = make(16, 3)
    print("nref=3 solver built: %d dofs, %.2f s"
          % (big.Z.dim, time.perf_counter() - t0), flush=True)
    _, t_big = _solve_sweep(big, [1, 10])
    print("nref=3: Re 1->10 in %.3f s" % t_big, flush=True)

    src = os.path.relpath(kernels.SOURCE,
                          os.path.dirname(os.path.abspath(__file__)))
    entries = []
    for use, name, replaces in (("K1", "K1 smoother L2", PALLAS_GEMV),
                                ("K2", "K2 level L2", XLA_LEVEL_APPLY)):
        for kname in ("gather_bgemv", "csr_segment_sum"):
            r = table[name][kname]
            entries.append({
                "name": "%s (%s, %s)" % (kname, use, name),
                "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[kname][use],
                "max_abs_err": r["abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
