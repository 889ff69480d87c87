"""sweep_s: the window's host seconds over the whole sweeps it ran (each
from rest to the ladder's top Reynolds number)."""


def read(record):
    n = len(record["sweeps"])
    return record["window_s"] / n if n else None
