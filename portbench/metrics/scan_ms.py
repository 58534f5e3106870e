"""Device time of the greedy scanner S1 (``csrc/scan.cu``, either form)
per collective, from the profile of the window."""

#: S1's kernels by the names the profiler gives them
S1_KERNELS = {"scan_resident", "scan_spread", "spread_hops", "spread_slots"}


def read(run):
    s = run.trace.device_s(S1_KERNELS)
    return 1e3 * s / run.collectives if s > 0 else None
