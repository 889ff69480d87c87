"""mg_setup_ms_per_newton: host milliseconds of a VelocityMG.setup call
(the multigrid set-up of one Newton step), synchronised on both sides,
averaged over the calls; the profiled sweep is left out."""

from benchmark.harness.stats import timed_sweeps


def read(record):
    calls = [t for s in timed_sweeps(record) for t in s.get("mg_setup_s", [])]
    return 1e3 * sum(calls) / len(calls) if calls else None
