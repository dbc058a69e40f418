"""Binomial survival-function evaluations the recombination filter makes a
job to build its keep tables: the program's counter
``filter.keep_table_sf_evals`` a stage run (counters.py).  Reads how the
tables are computed, not the data alone: the whole grid is
~150,000 a table at 1 Mb, a bisection on span ~200.  A program without the
counter reads None."""

from benchmark import counters


def read(ctx):
    return counters.per_job(ctx, "filter.keep_table_sf_evals")
