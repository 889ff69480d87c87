"""facet_tensors_ms_per_newton: the device milliseconds inside the
program's ``alfi.mg_setup.facet_tensors`` spans (Burman's facet Jacobians
of every level, formed in each multigrid set-up) in the profiled sweep's
traced steps, over those steps' Newton steps.  A program without the span
(no Burman stabilisation, or a program before the span) reads nothing."""

from benchmark.harness.program_spans import span_row, traced_counts


def read(record):
    row = span_row(record, "alfi.mg_setup.facet_tensors")
    counts = traced_counts(record)
    if row is None or not counts or not counts[1]:
        return None
    return 1e3 * row["device_s_incl"] / counts[1]
