#!/usr/bin/env python3
"""Check that the port's solves repeat bit for bit on one NVIDIA GPU.

    python3 chip_repeat.py [--reps N] [TREE ...]

For each checkout TREE (default: the directory of this script), in a
process of its own started in that directory, build a fresh solver N times
(default 3) and solve the first mesh of the [P2]^2-P0 MMS study
(examples/Makefile mms2dpkp0: baseN=8, nref=1, 2,690 dofs) over its ten
Re.  Each run prints its (Krylov, Newton) per Re, its seconds and the
SHA-256 of the bytes of every solution in order.  The Re 900 solve there
takes some 21 Krylov iterations per Newton step, and its count is the
first to move when the sums differ in their last bits.

To compare with another commit, unpack it into the git-ignored build/:

    git archive PARENT_COMMIT | tar -x -C build/parent
    python3 chip_repeat.py build/parent .

Exits 1 if the runs of this script's own checkout differ, or a run fails;
the runs of other trees are only reported.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

ARGV = ["--discretisation", "pkp0", "--mh", "uniform", "--k", "2",
        "--baseN", "8", "--nref", "1", "--solver-type", "almg"]


def child(reps):
    """The runs, in the current directory's alfi_torch."""
    sys.path.insert(0, os.getcwd())
    import torch

    from alfi_torch import get_default_parser, get_solver
    from alfi_torch.examples.mms import RES
    from alfi_torch.problems import TwoDimLidDrivenCavityMMSProblem

    args, _ = get_default_parser().parse_known_args(ARGV)
    for i in range(reps):
        t0 = time.perf_counter()
        solver = get_solver(args, TwoDimLidDrivenCavityMMSProblem(args.baseN),
                            device="cuda")
        h, counts = hashlib.sha256(), []
        for re in RES:
            z, info = solver.solve(re)
            counts.append((int(info["linear_iter"]),
                           int(info["nonlinear_iter"])))
            for part in z:
                h.update(part.detach().cpu().numpy().tobytes())
        torch.cuda.synchronize()
        print(json.dumps({"run": i, "re": RES, "counts": counts,
                          "sha256": h.hexdigest(),
                          "seconds": time.perf_counter() - t0}), flush=True)


def main():
    argv = sys.argv[1:]
    reps = 3
    if argv[:1] == ["--reps"]:
        reps, argv = int(argv[1]), argv[2:]
    if argv[:1] == ["--child"]:
        child(reps)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [os.path.abspath(t) for t in argv] or [here]
    bad = False
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--reps", str(reps),
             "--child"], cwd=tree, capture_output=True, text=True)
        runs = [json.loads(line) for line in proc.stdout.splitlines()
                if line.startswith("{")]
        for r in runs:
            print("%s run %d: %.3f s, sha256 %s, Krylov/Newton per Re %s"
                  % (tree, r["run"], r["seconds"], r["sha256"][:16],
                     dict(zip(r["re"], r["counts"]))), flush=True)
        same = (len({(r["sha256"], str(r["counts"])) for r in runs}) == 1)
        ok = proc.returncode == 0 and len(runs) == reps
        print("%s: %d of %d runs, exit %d, %s" % (
            tree, len(runs), reps, proc.returncode,
            "the runs repeat bit for bit" if same else "the runs differ"),
            flush=True)
        if not ok:
            print(proc.stderr[-4000:], file=sys.stderr)
        if not ok or (tree == here and not same):
            bad = True
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
