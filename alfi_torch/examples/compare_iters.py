"""Compare the solve records of two iters runs, Re by Re.

    python -m alfi_torch.examples.compare_iters A.log B.log

Each log is the standard output of an iters harness (this package's or
the JAX package's): ``run_solver`` prints one dict per Reynolds number
with ``Re``, ``linear_iter`` and ``nonlinear_iter``, and each solve
prints its Newton count ("Nonlinear solve ... in N iterations") and its
Krylov count ("Time taken: ... in K iterations").  Prints the number of
common Re, how many have equal Krylov and Newton counts, each Re that
differs, and the sums of both counts.
"""

import ast
import re
import sys


def solve_records(path):
    """{Re: (linear_iter, nonlinear_iter)} from the dict lines of a log;
    a dict line of a table-only checkpoint (no counts: 0/0) gives way to
    the counts the solve of that Re printed in the same log."""
    out, solved = {}, {}
    re_now = newton = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            m = re.search(r"Solving for Re = ([0-9.e+]+)", line)
            if m:
                re_now = float(m.group(1))
                continue
            m = re.search(r"Nonlinear solve \w+ in (\d+) iterations", line)
            if m:
                newton = int(m.group(1))
                continue
            m = re.search(r"Time taken: .* in (\d+) iterations", line)
            if m and re_now is not None:
                solved[re_now] = (int(m.group(1)), newton)
                continue
            if line.startswith("{'") and "'linear_iter'" in line:
                rec = ast.literal_eval(line)
                counts = (int(rec["linear_iter"]), int(rec["nonlinear_iter"]))
                if counts == (0, 0) and rec.get("checkpointed"):
                    counts = solved.get(float(rec["Re"]), counts)
                out[rec["Re"]] = counts
    return out


def main(argv=None):
    a_path, b_path = (argv or sys.argv[1:])[:2]
    a, b = solve_records(a_path), solve_records(b_path)
    common = sorted(set(a) & set(b))
    diff = [re for re in common if a[re] != b[re]]
    print("%d common Re, %d with equal Krylov/Newton counts"
          % (len(common), len(common) - len(diff)))
    for re in diff:
        print("  Re %s: %d/%d against %d/%d" % ((re,) + a[re] + b[re]))
    for name, rec in ((a_path, a), (b_path, b)):
        print("%s: Krylov %d, Newton %d over the common Re" % (
            name, sum(rec[re][0] for re in common),
            sum(rec[re][1] for re in common)))


if __name__ == "__main__":
    main()
