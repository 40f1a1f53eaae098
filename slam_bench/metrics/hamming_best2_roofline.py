"""K1's share of its roofline: the mean bound time of the `hamming_best2`
calls the window made (each call's bytes and operations from its shapes,
slam_bench/peaks.py) over the mean device time of a call (its main kernel
and its merge, by name from the profiler), in %."""

from slam_bench import peaks


def read(ctx):
    t = ctx.trace
    calls = ctx.k1_calls
    if not t or not calls or not t["k1_kernels"] or t["k1_device_s"] <= 0:
        return None
    bound = sum(peaks.hamming_best2_bound_s(n, m, k) for n, m, k in calls) / len(calls)
    return 100.0 * bound / (t["k1_device_s"] / t["k1_kernels"])
