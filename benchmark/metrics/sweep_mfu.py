"""The whole sweep's share of the card's b1 peak (%): the sweep's b1
operations (roofline.sweep_work) over the traced window's wall time."""

from benchmark import roofline


def read(ctx):
    t = ctx.trace
    if ctx.unit != "sweep" or not t or t["window_s"] <= 0:
        return None
    ops, _bytes = roofline.sweep_work(*roofline.traced_sweep(ctx))
    return 100.0 * ops * t["units"] / t["window_s"] / roofline.PEAK_B1
