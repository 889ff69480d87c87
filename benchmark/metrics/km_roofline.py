"""km_roofline: the bytes the profiled sweep's level applies need
(bounds.km_counts, from the merged operators' live blocks) over the
H100's HBM bandwidth, as a share of the device time of the kernels
launched inside the bench.km ranges."""

from benchmark.harness.stats import range_share


def read(record):
    return range_share(record, "km")
