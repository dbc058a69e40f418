"""Seconds a job in the stage's own per-block tail, over the jobs run with
the profiler off: the phase spans "block rows [r0,r1)" of
stages/distance.py (years, lookup, CSV, write, cursor), the model's time
included (spans.py, span ``stage_tail``)."""


def read(ctx):
    total = ctx.spans.total("stage_tail")
    return None if total is None or ctx.unit != "job" else total / ctx.units
