"""patch_inverse_ms_per_newton: the device milliseconds inside the
program's ``alfi.mg_setup.patch_inverse`` spans (the patch contraction and
the batched inverses of the multigrid set-up) in the profiled sweep's
traced steps, over those steps' Newton steps."""

from benchmark.harness.program_spans import span_row, traced_counts


def read(record):
    row = span_row(record, "alfi.mg_setup.patch_inverse")
    counts = traced_counts(record)
    if row is None or not counts or not counts[1]:
        return None
    return 1e3 * row["device_s_incl"] / counts[1]
