"""peak_gb: the device memory allocated at the window's peak, from a reset
at its start with the solver resident (torch.cuda.max_memory_allocated),
in 1e9 bytes."""


def read(record):
    b = record["peak_bytes"]
    return b / 1e9 if b else None
