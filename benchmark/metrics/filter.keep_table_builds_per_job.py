"""Keep tables the recombination filter builds a job, one per distinct
distance above 1 among its survivors: the program's counter
``filter.keep_table_builds`` a stage run (counters.py).  Set by the data: a
fall means that jobs ran warm on tables kept across them, not that a job
got faster."""

from benchmark import counters


def read(ctx):
    return counters.per_job(ctx, "filter.keep_table_builds")
