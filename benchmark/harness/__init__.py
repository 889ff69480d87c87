"""The general parts of the benchmark: registry, traffic, window, spans,
trace reading, byte counts and the correctness check."""
