"""The headline iteration-robustness experiment (the reference's
examples/iters.py, and the JAX package's ``examples/iters.py``): for a
range of refinement levels and a Reynolds sweep up to 10,000, collect
the average Krylov iterations per Newton step and the wall-clock, and
print the papers' two LaTeX tables.

Usage (the papers' protocol, on the card):
  python -m alfi_torch.examples.iters --problem ldc2d --discretisation pkp0 \\
      --mh uniform --stabilisation-type supg --restriction \\
      --nref-start 1 --nref-end 2 --re-max 10000 [--checkpoint]

``--problem`` is one of ldc2d, ldc3d, bfs2d, bfs3d, dfg (the steps and
dfg read a gmsh file given by ``--mesh``, or generate their mesh without
one; dfg's generated channel has ``--n`` cells per unit length).
``--device`` (default ``cuda``) picks the torch device; ``--device cpu``
runs the same protocol on the host.
"""

import math

from alfi_torch import get_default_parser, get_solver, run_solver
from alfi_torch.problems import (
    DfgBenchmarkProblem,
    ThreeDimBackwardsFacingStepProblem,
    ThreeDimLidDrivenCavityProblem,
    TwoDimBackwardsFacingStepProblem,
    TwoDimLidDrivenCavityProblem,
)


def reynolds_ladder(re_max, bfs=False):
    """[1, 10, 100, 200, 300, ..., 10000] up to ``re_max``; the
    backwards-facing steps add Re 50, 150, 250, 350."""
    res = [1, 10, 100] + list(range(200, 10000 + 100, 100))
    res = [r for r in res if r <= re_max]
    return sorted(res + [50, 150, 250, 350]) if bfs else res


def sci_latex(n):
    """Dof count as LaTeX scientific notation, $m.mm\\times 10^e$."""
    e = int(math.floor(math.log10(max(n, 1))))
    return "$%.2f\\times 10^%d$" % (n / 10.0 ** e, e)


def main(argv=None):
    parser = get_default_parser()
    parser.add_argument("--problem", type=str, required=True,
                        choices=["ldc2d", "bfs2d", "ldc3d", "bfs3d",
                                 "dfg"])
    parser.add_argument("--diagonal", type=str, default="left",
                        choices=["left", "right", "crossed"])
    parser.add_argument("--mesh", type=str)
    parser.add_argument("--nref-start", type=int, required=True)
    parser.add_argument("--nref-end", type=int, required=True)
    parser.add_argument("--re-max", type=int, default=10000)
    parser.add_argument("--singular", dest="singular", default=False,
                        action="store_true")
    parser.add_argument("--n", type=int, default=40)
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)

    if args.problem == "ldc2d":
        problem = TwoDimLidDrivenCavityProblem(
            args.baseN, args.diagonal, regularised=not args.singular)
    elif args.problem == "bfs2d":
        problem = TwoDimBackwardsFacingStepProblem(args.mesh)
    elif args.problem == "ldc3d":
        problem = ThreeDimLidDrivenCavityProblem(args.baseN)
    elif args.problem == "bfs3d":
        problem = ThreeDimBackwardsFacingStepProblem(args.mesh)
    else:
        problem = DfgBenchmarkProblem(args.mesh, n=args.n)

    res = reynolds_ladder(args.re_max, bfs=args.problem.startswith("bfs"))
    results, dofs = {}, {}
    nrefs = range(args.nref_start, args.nref_end + 1)
    tableres = [i for i in [10, 100, 1000, 5000, 10000] if i <= max(res)]
    for nref in nrefs:
        args.nref = nref
        solver = get_solver(args, problem, device=args.device)
        dofs[nref] = solver.Z.dim
        res_tmp = run_solver(solver, res, args)
        results[nref] = {re: res_tmp[re] for re in tableres}

    def emit(extract):
        """One LaTeX tabular body: header (nref, dofs, Re columns),
        one row per refinement level, cells tab-&-separated."""
        grid = [["nref\t", "dofs\t"] + [str(re) for re in tableres]]
        for nref in nrefs:
            cells = [str(nref), sci_latex(dofs[nref])]
            cells += ["%.2f" % extract(results[nref][re])
                      for re in tableres]
            grid.append(cells)
        print(" \\\\\n".join("\t& ".join(row) for row in grid) + "\\\\")

    # table 1: average Krylov iterations per Newton step
    emit(lambda r: float(r["linear_iter"] / max(1, r["nonlinear_iter"])))
    # table 2: time per Re in seconds
    emit(lambda r: float(r["time"] * 60))


if __name__ == "__main__":
    main()
