"""host_syncs_per_krylov_it: the program's counted device-to-host scalar
reads (``alfi_torch.utils.events.COUNTERS["host_reads"]``, each a wait for
the device) over the window's unprofiled sweeps, per outer Krylov
iteration of the same sweeps."""

from benchmark.harness.stats import timed_sweeps


def read(record):
    sweeps = [s for s in timed_sweeps(record) if "host_reads" in s]
    its = sum(sum(s["krylov"]) for s in sweeps)
    if not its:
        return None
    return sum(s["host_reads"] for s in sweeps) / its
