"""k1_roofline: the bytes the profiled sweep's patch applies need
(bounds.k1_counts, from the tables' live patch sizes) over the H100's
HBM bandwidth, as a share of the device time of the kernels launched
inside the bench.k1 ranges."""

from benchmark.harness.stats import range_share


def read(record):
    return range_share(record, "k1")
