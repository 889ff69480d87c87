"""Velocity-block gamma-robustness study (the reference's
examples/graddiv/graddiv.py, and the JAX package's
``examples/graddiv.py``): sweep gamma in {0, 1, 10, ..., 1e8} for one
smoother x transfer combination and print the LaTeX iteration table.

Usage (on the card; ``--device cpu`` runs it on the host):
  python -m alfi_torch.examples.graddiv --dim 2 --discretisation pkp0 \\
      --smoother patch --transfer --baseN 8 --nref 2 --k 2
"""

from alfi_torch import get_default_parser
from alfi_torch.graddiv import GradDivSolver

GAMMAS = [0.0, 1.0, 1e1, 1e2, 1e3, 1e4, 1e6, 1e8]


def main(argv=None):
    """Run the sweep; returns the printed iteration cells (">200" for a
    solve that did not converge)."""
    parser = get_default_parser()
    parser.add_argument("--dim", type=int, required=True, choices=[2, 3])
    parser.add_argument("--transfer", dest="transfer", default=False,
                        action="store_true")
    parser.add_argument("--diagonal", type=str, default="left",
                        choices=["left", "right", "crossed"])
    parser.add_argument("--smoother", type=str, required=True,
                        choices=["patch", "jacobi", "amg"])
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)

    s = GradDivSolver(
        dim=args.dim, baseN=args.baseN, nref=args.nref, k=args.k,
        discretisation=args.discretisation, hierarchy=args.mh,
        patch=args.patch, smoother=args.smoother, transfer=args.transfer,
        diagonal=args.diagonal,
        smoothing=args.smoothing if args.smoothing else 3,
        device=args.device)

    iters = []
    for g in GAMMAS:
        _, its, conv = s.solve(g)
        iters.append(str(its) if conv else ">200")
        print(f"gamma = {g:g}: {iters[-1]} iterations", flush=True)

    print("gamma:   " + "\t& ".join("%g" % g for g in GAMMAS) + "\\\\")
    print("iters:   " + "\t& ".join(iters) + "\\\\")
    return iters


if __name__ == "__main__":
    main()
