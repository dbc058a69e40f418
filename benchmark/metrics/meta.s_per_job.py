"""Seconds a job in the transmission model, over the jobs run with the
profiler off: TransClusterCache.lookup as stages/distance.py calls it, the
card synchronised (spans.py, span ``meta``)."""


def read(ctx):
    total = ctx.spans.total("meta")
    return None if total is None or ctx.unit != "job" else total / ctx.units
