#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of two checkouts alternately on one NVIDIA GPU:
parent, change, change, parent, each in its own process, from its own
directory.

    git archive PARENT_COMMIT | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 chip_ab.py build/parent build/change OUT_DIR

(``build/`` is git-ignored.)  The whole output of run i goes to
``OUT_DIR/ab_<i>_<parent|change>.log``.  For each run this prints its
exit code and the lines that carry the comparison: the kernel rows, the
bench sweep, the profiled linear steps, the Jacobian action, the nref=3
sweep and the driver sweeps (2D headline, 3D scale row, 3D step).  Exits non-zero if any run failed.
"""

import os
import subprocess
import sys

ORDER = ("parent", "change", "change", "parent")
KEYS = ("K1 ", "K2 ", "K3 ", "kernel build:", "bench config:",
        "profiled linear step:", "Jacobian action", "nref=3: Re",
        "headline protocol", "3D scale row", "3D step")


def main(parent, change, out_dir):
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


if __name__ == "__main__":
    if len(sys.argv) != 4:
        raise SystemExit(__doc__)
    sys.exit(main(*sys.argv[1:]))
