"""Split layouts built on the card a job: the program's counter
``layout.device_builds`` a stage run (counters.py).  1 where a job builds its
layout on the card from the uploaded planes (the one-device CUDA path), 0 or
nothing where the host builds it (the CPU, a mesh, a program without the
counter)."""

from benchmark import counters


def read(ctx):
    return counters.per_job(ctx, "layout.device_builds")
