"""smoother_gs_ms_per_krylov_it: the self device milliseconds of the
program's ``alfi.smooth`` spans (the level smoothers' Krylov arithmetic:
Gram-Schmidt, Givens rotations, norms and basis copies, with the patch
and level applies inside them left out) in the profiled sweep's traced
steps, over those steps' outer Krylov iterations."""

from benchmark.harness.program_spans import span_row, traced_counts


def read(record):
    row, counts = span_row(record, "alfi.smooth"), traced_counts(record)
    if row is None or not counts or not counts[0]:
        return None
    return 1e3 * row["device_s"] / counts[0]
