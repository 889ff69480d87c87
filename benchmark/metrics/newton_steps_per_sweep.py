"""newton_steps_per_sweep: the program's info_dict["nonlinear_iter"]
summed over the window, per sweep."""

from benchmark.harness.stats import per_sweep


def read(record):
    return per_sweep(record, "newton")
