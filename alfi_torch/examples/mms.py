"""MMS convergence-order study (the reference's examples/mms.py, and the
JAX package's ``examples/mms.py``): per (nref, Re) compute |u-u_h|,
|grad(u-u_h)|, |p-p_h| (both mean-zero) and |div u_h|, print the
convergence orders log2(e_i/e_{i+1}) and the pgfplots tables.

Usage (on the card; ``--device cpu`` runs it on the host):
  python -m alfi_torch.examples.mms --dim 2 --discretisation pkp0 \\
      --mh uniform --k 2 --baseN 4 --nref 4 [--solver-type lu ...]
"""

import numpy as np

from alfi_torch import get_default_parser, get_solver
from alfi_torch.fem.errors import ErrorComputer
from alfi_torch.problems import (
    ThreeDimLidDrivenCavityMMSProblem,
    TwoDimLidDrivenCavityMMSProblem,
)

#: the Reynolds numbers of the study, solved in this order per nref
RES = [1, 9, 10, 50, 90, 100, 400, 500, 900, 1000]


def convergence_orders(x):
    x = np.asarray(x)
    return np.log2(x[:-1] / x[1:])


_WORDS = {1: "one", 10: "ten", 100: "onehundred", 500: "fivehundred",
          1000: "onethousand", 10000: "tenthousand"}


def numtoword(n):
    return _WORDS.get(int(n), str(int(n)).replace("0", "zero"))


def main(argv=None):
    """Run the study; returns {"results": {Re: {key: [per nref]}},
    "hs": [(hmax, havg) per nref], "counts": {(nref, Re): (Krylov,
    Newton)}}."""
    parser = get_default_parser()
    parser.add_argument("--dim", type=int, required=True, choices=[2, 3])
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)

    if args.dim == 2:
        problem = TwoDimLidDrivenCavityMMSProblem(args.baseN)
    else:
        problem = ThreeDimLidDrivenCavityMMSProblem(args.baseN)

    keys = ["velocity", "velocitygrad", "pressure", "divergence",
            "relvelocity", "relvelocitygrad", "relpressure"]
    results = {re: {s: [] for s in keys} for re in RES}
    hs, counts = [], {}
    max_nref = args.nref
    for nref in range(1, max_nref + 1):
        args.nref = nref
        solver = get_solver(args, problem, device=args.device)
        h = solver.mesh.cell_sizes()
        hs.append((float(h.max()), float(h.mean())))
        ec = ErrorComputer(solver.form)
        for re in RES:
            z, info = solver.solve(re)
            counts[(nref, re)] = (int(info["linear_iter"]),
                                  int(info["nonlinear_iter"]))
            u, p = z
            nu = solver.nu_val

            def p_exact(x):
                return problem.p_exact(x, nu)

            ul2, uh1 = ec.velocity_errors(u, problem.u_exact)
            pl2 = ec.pressure_error(p, p_exact)
            div = ec.divergence_norm(u)
            # exact-field norms for relative errors
            zero = solver.Z.zero(solver.device)
            el2, eh1 = ec.velocity_errors(zero[0], problem.u_exact)
            ep = ec.pressure_error(zero[1], p_exact)
            r = results[re]
            r["velocity"].append(float(ul2))
            r["velocitygrad"].append(float(uh1))
            r["pressure"].append(float(pl2))
            r["divergence"].append(float(div))
            r["relvelocity"].append(float(ul2 / el2))
            r["relvelocitygrad"].append(float(uh1 / eh1))
            r["relpressure"].append(float(pl2 / ep))
            print("|div(u_h)| = ", float(div))

    for re in RES:
        print("Results for Re =", re)
        print("|u-u_h|", results[re]["velocity"])
        print("convergence orders:",
              convergence_orders(results[re]["velocity"]))
        print("|p-p_h|", results[re]["pressure"])
        print("convergence orders:",
              convergence_orders(results[re]["pressure"]))
    print("gamma =", args.gamma)
    print("h =", hs)

    for re in [10, 100, 500, 1000]:
        print("%%Re = %i" % re)
        print("\\pgfplotstableread[col sep=comma, row sep=\\\\]{%%")
        print("hmin,havg,error_v,error_vgrad, error_p,relerror_v, "
              "relerror_vgrad,relerror_p,div\\\\")
        r = results[re]
        for i in range(len(hs)):
            print(",".join(map(str, [
                hs[i][0], hs[i][1], r["velocity"][i],
                r["velocitygrad"][i], r["pressure"][i],
                r["relvelocity"][i], r["relvelocitygrad"][i],
                r["relpressure"][i], r["divergence"][i]])) + "\\\\")
        name = ("re" + numtoword(re) + "gamma" + numtoword(args.gamma)
                + args.discretisation.replace("0", "zero"))
        print("}\\%s" % name)
    return {"results": results, "hs": hs, "counts": counts}


if __name__ == "__main__":
    main()
