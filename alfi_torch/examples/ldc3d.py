"""3D lid-driven cavity (examples/ldc3d/ldc3d.py of the reference, and
the JAX package's ``examples/ldc3d.py``): Re 1, 10, 100 through the
driver.

Usage (on the card; ``--device cpu`` runs it on the host):
  python -m alfi_torch.examples.ldc3d --discretisation pkp0 --mh uniform \\
      --k 2 --baseN 4 --nref 1 [--stabilisation-type supg --restriction]
"""

from alfi_torch import get_default_parser, get_solver, run_solver
from alfi_torch.problems import ThreeDimLidDrivenCavityProblem


def main(argv=None):
    parser = get_default_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)
    problem = ThreeDimLidDrivenCavityProblem(args.baseN)
    solver = get_solver(args, problem, device=args.device)
    return run_solver(solver, [1, 10, 100], args)


if __name__ == "__main__":
    main()
