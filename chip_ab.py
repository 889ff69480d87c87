#!/usr/bin/env python3
"""Compare builds of the port on one NVIDIA GPU.

1. Run ``chip_smoke.py`` of two checkouts alternately: parent, change,
   change, parent, each in its own process, from its own directory.

       git archive PARENT_COMMIT | tar -x -C build/parent
       git archive $(git write-tree) | tar -x -C build/change
       python3 chip_ab.py build/parent build/change OUT_DIR

   (``build/`` is git-ignored.)  The whole output of run i goes to
   ``OUT_DIR/ab_<i>_<parent|change>.log``.  For each run this prints its
   exit code and the lines that carry the comparison: the kernel rows, the
   bench sweep, the profiled linear steps, the Jacobian action, the nref=3
   sweep and the continuation sweeps (2D headline, 3D scale row, 3D step).
   Exits non-zero if any run failed.

2. What held the strided kernel of commit bf9f89e (the fused
   gather-GEMV-scatter for odd and long rows, before it learned the
   blocks' live extents) below the memory rate on the 3D star tables: its
   gathers, or its bytes?

       git archive bf9f89e | tar -x -C build/parent
       python3 chip_ab.py --ablate build/parent

   A record of the measurement behind that kernel's redesign; nothing
   else runs it.  It times three builds of that checkout's
   ``alfi_torch/csrc/gather_gemv_scatter.cu``, each in its own process, on
   the star tables of the 3D scale row (4,913 x 189 and 729 x 189) and of
   the 3D step (2,184 x 201), with the main path's masks and random f64
   inputs:

   * ``as is``;
   * ``no x gather``: ``x[g[u]]`` replaced by the constant 1.0, so that
     the scattered 8-byte loads of x are gone and the index row is still
     read;
   * ``no x gather, no index row``: ``grow[j]`` replaced by 0 as well.

   The variants compute something else than the function; only their
   device times (torch.profiler, mean of 20 launches) are read.  The
   bytes of A that this strided kernel loads (every column of a live row)
   are the same in all three.  The checkout's source is restored at the
   end.
"""

import os
import subprocess
import sys

ORDER = ("parent", "change", "change", "parent")
KEYS = ("K1 ", "K2 ", "K3 ", "kernel build:", "bench config:",
        "profiled linear step:", "Jacobian action", "nref=3: Re",
        "headline protocol", "3D scale row", "3D step")


def alternate(parent, change, out_dir):
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    dirs = {"parent": parent, "change": change}
    failed = False
    for i, label in enumerate(ORDER, 1):
        log = os.path.join(out_dir, "ab_%d_%s.log" % (i, label))
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"],
                                cwd=dirs[label], stdout=f,
                                stderr=subprocess.STDOUT).returncode
        print("== run %d, %s (%s): rc=%d" % (i, label, dirs[label], rc),
              flush=True)
        with open(log) as f:
            for line in f:
                if line.startswith(KEYS):
                    print(line.rstrip())
        failed = failed or rc != 0
    return 1 if failed else 0


VARIANTS = (
    ("as is", ()),
    ("no x gather", (("xv[u] = g[u] >= 0 ? x[g[u]] : 0.0;",
                      "xv[u] = g[u] >= 0 ? 1.0 : 0.0;"),)),
    ("no x gather, no index row",
     (("xv[u] = g[u] >= 0 ? x[g[u]] : 0.0;", "xv[u] = g[u] >= 0 ? 1.0 : 0.0;"),
      ("g[u] = in ? grow[j] : -1;", "g[u] = in ? 0 : -1;"))),
)
SOURCE = os.path.join("alfi_torch", "csrc", "gather_gemv_scatter.cu")


def ablate_child():
    """Time the star tables with the kernel built from the working
    directory's checkout."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from alfi_torch import get_default_parser, get_solver
    from alfi_torch.problems import (
        ThreeDimBackwardsFacingStepProblem,
        ThreeDimLidDrivenCavityProblem,
    )

    dev = torch.device("cuda")
    parser = get_default_parser()
    scale_args = parser.parse_args(cs.SCALE_ARGV)
    step_args = parser.parse_args(cs.STEP_ARGV)
    scale = get_solver(scale_args, ThreeDimLidDrivenCavityProblem(
        scale_args.baseN), device=dev)
    step = get_solver(step_args, ThreeDimBackwardsFacingStepProblem(
        cs.STEP_MESH), device=dev)
    rng = np.random.default_rng(0)
    for name, op in (("3D L2", scale.vmg.patch_solvers[1][1]),
                     ("3D L1", scale.vmg.patch_solvers[0][1]),
                     ("step L1", step.vmg.patch_solvers[0][1])):
        nb, m, _ = op.ashape
        A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev)
        x = torch.as_tensor(rng.standard_normal(op.n), device=dev)
        p = torch.as_tensor(rng.standard_normal(op.n), device=dev)
        op(A, x, p)
        ms = cs._device_ms(lambda: op(A, x, p), only=cs.KERNEL_NAME)
        rows = int(op.slots.numel())  # live rows, each loaded whole
        print("  K1 smoother %-8s %5d x %-3d  %8.1f us  (%.3f GB of A "
              "loaded, %.2f TB/s)" % (name, nb, m, 1e3 * ms,
                                      8e-9 * rows * m,
                                      8e-9 * rows * m / ms), flush=True)
        del A


def ablate(parent):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    path = os.path.join(parent, SOURCE)
    with open(path) as f:
        original = f.read()
    failed = False
    try:
        for label, edits in VARIANTS:
            source = original
            for old, new in edits:
                if source.count(old) != 1:
                    raise SystemExit("%s: expected one %r" % (path, old))
                source = source.replace(old, new)
            with open(path, "w") as f:
                f.write(source)
            print("strided kernel, %s:" % label, flush=True)
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--ablate-child"], cwd=parent).returncode
            failed = failed or rc != 0
    finally:
        with open(path, "w") as f:
            f.write(original)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--ablate-child"]:
        ablate_child()
    elif len(sys.argv) == 3 and sys.argv[1] == "--ablate":
        sys.exit(ablate(sys.argv[2]))
    elif len(sys.argv) == 4:
        sys.exit(alternate(*sys.argv[1:]))
    else:
        raise SystemExit(__doc__)
