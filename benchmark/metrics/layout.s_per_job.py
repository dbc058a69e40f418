"""Seconds a job in the host layout, over the jobs run with the profiler
off: compact_variant_columns and split_alignment as ops/pairsnp.py calls
them (spans.py, span ``layout``)."""


def read(ctx):
    total = ctx.spans.total("layout")
    return None if total is None or ctx.unit != "job" else total / ctx.units
