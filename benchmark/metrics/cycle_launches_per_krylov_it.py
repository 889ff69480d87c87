"""cycle_launches_per_krylov_it: the runtime calls that put work on a
stream (kernel launches, asynchronous copies and sets) made inside the
program's ``alfi.pc_apply`` spans, children included, in the profiled
sweep's traced steps, over those steps' outer Krylov iterations: the
launches of one Schur preconditioner apply (two FMG cycles)."""

from benchmark.harness.program_spans import span_row, traced_counts


def read(record):
    row, counts = span_row(record, "alfi.pc_apply"), traced_counts(record)
    if row is None or not counts or not counts[0]:
        return None
    return row["launches_incl"] / counts[0]
