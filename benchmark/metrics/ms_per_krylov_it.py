"""ms_per_krylov_it: the program's KSPSolve seconds less the multigrid
set-up's (the bench.mg_setup span), over the outer Krylov iterations: the
Krylov loop, the Schur preconditioner and the FMG cycle per iteration.
The profiled sweep is left out."""

from benchmark.harness.stats import timed_sweeps


def read(record):
    sweeps = [s for s in timed_sweeps(record) if "mg_setup_s" in s]
    its = sum(sum(s["krylov"]) for s in sweeps)
    if not its:
        return None
    cycle = sum(s["ksp_s"] - sum(s["mg_setup_s"]) for s in sweeps)
    return 1e3 * cycle / its
