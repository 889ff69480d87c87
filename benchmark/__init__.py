"""The benchmark of the alfi_torch port on an NVIDIA H100 (see README.md)."""
