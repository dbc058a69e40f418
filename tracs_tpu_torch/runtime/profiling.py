"""Observability: phase timing and throughput logging at DEBUG level
(counterpart of tracs_tpu/runtime/profiling.py; run with ``--loglevel DEBUG``
to see them).

* ``phase(label)``      — context manager logging the wall time of a phase.
* ``rate_logger(unit)`` — returns a callable accumulating work items and
                          logging the cumulative throughput (e.g. pairs/s).
"""

from __future__ import annotations

import contextlib
import logging
import time


@contextlib.contextmanager
def phase(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logging.debug("[phase] %s: %.3fs", label, time.perf_counter() - t0)


def rate_logger(unit: str = "items"):
    """Returns ``log(n_done)``: call with the number of work items finished
    since the previous call; logs cumulative count and rate."""
    state = {"t0": time.perf_counter(), "n": 0}

    def log(n_done: int):
        state["n"] += int(n_done)
        dt = time.perf_counter() - state["t0"]
        if dt > 0:
            logging.debug(
                "[rate] %s %s in %.1fs (%.0f %s/s)",
                f"{state['n']:,}", unit, dt, state["n"] / dt, unit,
            )

    return log
