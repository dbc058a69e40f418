"""Seconds a job in the recombination filter, over the jobs run with the
profiler off: filter_pairs as ops/pairsnp.py calls it (spans.py, span
``filter``)."""


def read(ctx):
    total = ctx.spans.total("filter")
    return None if total is None or ctx.unit != "job" else total / ctx.units
