"""Pairs within the threshold a sweep: the program's counter
``sweep.survivors`` a sweep (sweep_counters.py).  Set by the data and the
threshold: every sweep of a run sweeps the same alignment, so it reads the
survivors of one sweep; each survivor is 16 B copied to the host and a row
the caller handles."""

from benchmark import sweep_counters


def read(ctx):
    return sweep_counters.per_sweep(ctx, "sweep.survivors")
