"""re_step_p95_s: the 95th percentile (nearest rank) of the host seconds
of the window's Reynolds steps (NavierStokesSolver.solve), the profiled
sweep left out."""

from benchmark.harness.stats import percentile, timed_sweeps


def read(record):
    return percentile([t for s in timed_sweeps(record) for t in s["re_s"]],
                      95)
