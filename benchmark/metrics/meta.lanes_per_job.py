"""Novel (N, delta) lanes a job hands the transmission model: the program's
counter ``meta.lanes`` a stage run (counters.py).  Set by the data: a fall
means that jobs ran warm on a memo kept across them, not that a job got
faster."""

from benchmark import counters


def read(ctx):
    return counters.per_job(ctx, "meta.lanes")
