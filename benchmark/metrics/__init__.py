"""Per-layer metric readers, one file each, found by the metric's name:
``read(record)`` returns the metric's value, or None where the run's
record has nothing to read."""
