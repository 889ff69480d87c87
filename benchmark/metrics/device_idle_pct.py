"""device_idle_pct: 100 less the share of the traced steps in which some
operation ran on the device.  The busy time is the union of the device
intervals of the profiled sweep's traced steps; their length is the mean
wall time of the same steps in the window's unprofiled sweeps, since the
profiler slows the host, not the device, and the traced span itself would
count that slowing as idle."""

from benchmark.harness.stats import timed_sweeps


def read(record):
    tr = record.get("trace")
    prof = [s for s in record["sweeps"] if s["profiled"]]
    walls = [sum(s["re_s"][i] for i in prof[0]["traced_steps"])
             for s in timed_sweeps(record)] if prof else []
    if not tr or tr["busy_s"] <= 0 or not walls:
        return None
    return 100.0 * (1.0 - tr["busy_s"] * len(walls) / sum(walls))
