"""k-loop steps a job in the transmission model: the program's counter
``meta.k_steps`` (each k block's steps, every lane of the block advancing
one k a step) a stage run (counters.py).  Set by the data and the model;
each step is a chain of some 50 elementwise launches on the card."""

from benchmark import counters


def read(ctx):
    return counters.per_job(ctx, "meta.k_steps")
