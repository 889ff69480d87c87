"""DFG cylinder benchmark (the reference's examples/dfg/dfg.py, and the
JAX package's ``examples/dfg.py``): the Reynolds ladder [1, 10, 20, 50]
through the driver, extended to 100, 200, 400, 500 by ``--re-max``.

Usage (on the card; ``--device cpu`` runs it on the host):
  python -m alfi_torch.examples.dfg --discretisation pkp0 --mh uniform \\
      --k 2 --nref 1 --stabilisation-type supg --restriction \\
      [--n 40] [--re-max 500] [--checkpoint]
"""

from alfi_torch import get_default_parser, get_solver, run_solver
from alfi_torch.problems import DfgBenchmarkProblem

#: the ladder; the reference runs [1, 10, 20, 50] and keeps the rest as a
#: commented extension (examples/dfg/dfg.py:56), which --re-max > 50
#: turns on
LADDER = [1, 10, 20, 50, 100, 200, 400, 500]


def main(argv=None):
    parser = get_default_parser()
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--n", type=int, default=40)
    parser.add_argument("--re-max", type=int, default=50)
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)
    problem = DfgBenchmarkProblem(args.mesh, n=args.n)
    solver = get_solver(args, problem, device=args.device)
    return run_solver(solver, [r for r in LADDER if r <= args.re_max],
                      args)


if __name__ == "__main__":
    main()
