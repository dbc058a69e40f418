"""The sweep's share of its roofline (%): the least time of the traced
sweeps (roofline.sweep_bound, counted from the inputs) over the device's
busy time while they ran."""

from benchmark import roofline


def read(ctx):
    t = ctx.trace
    if ctx.unit != "sweep" or not t or t["busy_s"] <= 0:
        return None
    bound_s, _by = roofline.sweep_bound(*roofline.traced_sweep(ctx))
    return 100.0 * bound_s * t["units"] / t["busy_s"]
