"""Observability: phase timing, throughput logging and device traces
(counterpart of tracs_tpu/runtime/profiling.py; run with ``--loglevel DEBUG``
to see the timings).

* ``phase(label, device)`` — context manager logging the wall time of a
                             phase; with a CUDA ``device`` the card is
                             synchronised before each clock read, so the time
                             holds the device work the phase launched.
* ``rate_logger(unit)``    — returns a callable accumulating work items and
                             logging the cumulative throughput (e.g. pairs/s).
* ``trace(label, trace_dir)`` — records a ``torch.profiler`` trace of the
                             host and, where a card exists, of its kernels,
                             and writes it to ``trace_dir`` as a Chrome trace
                             (chrome://tracing, Perfetto).  Where tracs_tpu
                             reads the directory from ``TRACS_TPU_PROFILE``,
                             the caller passes it here; None records nothing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(label: str, device=None):
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
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


@contextlib.contextmanager
def trace(label: str = "tracs_tpu_torch", trace_dir: str | os.PathLike | None = None):
    """Profiles the body into ``trace_dir/<label>.<pid>.trace.json``.  The
    ``with`` target is the ``torch.profiler.profile`` (its ``key_averages()``
    are complete once the block has ended), or None when ``trace_dir`` is
    None."""
    if trace_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(os.fspath(trace_dir), f"{label}.{os.getpid()}.trace.json")
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    logging.info("[profile] wrote the trace of %r to %s", label, path)
