"""Bytes of survivors a sweep copies from the card to the host: the
program's counter ``sweep.copied_bytes`` (``_extract_coo``'s one copy a
block) a sweep (sweep_counters.py); 16 B a survivor on one card."""

from benchmark import sweep_counters


def read(ctx):
    return sweep_counters.per_sweep(ctx, "sweep.copied_bytes")
