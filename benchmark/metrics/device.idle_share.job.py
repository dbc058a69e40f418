"""The device's idle share over the traced jobs: 1 - busy / window, from
the profiler's union of kernel, copy and memset intervals."""


def read(ctx):
    t = ctx.trace
    if ctx.unit != "job" or not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
