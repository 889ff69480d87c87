"""Experiment harnesses of the port, run as ``python -m
alfi_torch.examples.<name>``."""
