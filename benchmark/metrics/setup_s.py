"""setup_s: host seconds from the start of run.py to the window's start:
import, the kernels built or loaded, the solver built, the warm-up solve
and the reset."""


def read(record):
    return record["setup_s"]
