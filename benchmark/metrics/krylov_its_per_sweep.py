"""krylov_its_per_sweep: the program's info_dict["linear_iter"] (outer
FGMRES iterations) summed over the window, per sweep."""

from benchmark.harness.stats import per_sweep


def read(record):
    return per_sweep(record, "krylov")
