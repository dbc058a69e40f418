"""Spans and counters of the port: where a ``distance`` run spends its time
and how much work each layer did (counterpart of
tracs_tpu/runtime/profiling.py).

The operator's switch is ``--loglevel DEBUG``: ``distance`` then records
spans and, at its end, logs one line per span name (count, total seconds,
self seconds) and one per counter, besides a line per row block and per
stage phase.  Without it nothing is recorded and no clock is read.

* ``span(name, **attrs)`` — context manager.  While recording is on it
  keeps ``Span(name, t0, t1, parent, run, attrs, id)``: ``t0``/``t1`` on
  ``time.perf_counter()``, ``parent`` the id of the span open in the thread
  when it began, ``run`` the id of the ``pairsnp_stream`` or
  ``_distance_streaming`` call it belongs to (``run``, ``run_steps``).
  While recording is off it tests one module bool and returns a shared
  no-op context; ``spanned(name)`` makes each call of a function a span.
  A span never synchronises the device: one whose work
  ends in a host read (``to_host``, boolean indexing, a pageable ``.to``)
  holds the device work before that read; any other holds launch time.
* ``count(name, n=1)`` — adds ``n`` to ``counters[name]``, always; while
  recording is on each increment is also kept with its time.  ``counter``
  reads one, ``reset`` zeroes those of a prefix.  Two count whole runs, so
  that a reader can put another counter per run: ``stage.runs``, one a
  ``distance`` streaming run, and ``sweep.runs``, one a ``pairsnp_stream``
  call that sweeps (ops/pairsnp.py), beside which ``sweep.survivors`` and
  ``sweep.copied_bytes`` (the survivors' copy to the host) are counted.
* ``enable()`` / ``disable()`` / ``since(t)`` — recording on and off, and a
  ``Trace`` of the spans begun and the increments made at ``t`` or later
  (``table()``: spans, seconds and self seconds by name; ``count(name)``).
  Both buffers hold the newest ``LIMIT`` records; the ones dropped for
  room are counted in ``trace.dropped``.
* ``phase(label, device)`` — the stage's per-block span ``stage.tail``;
  with DEBUG enabled it also synchronises ``device`` at both ends and logs
  the seconds.
* ``log_summary(trace)`` — the end-of-run lines.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import threading
import time
from typing import NamedTuple

#: the most spans, and the most counter increments, one recording holds
LIMIT = 1 << 20

#: every counter's total since the process started (or its ``reset``)
counters: dict[str, int] = {}

_on = False
_spans: collections.deque = collections.deque(maxlen=LIMIT)
_increments: collections.deque = collections.deque(maxlen=LIMIT)
_local = threading.local()
_ids = itertools.count(1)
_runs = itertools.count(1)
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    parent: int | None
    run: int | None
    attrs: dict
    id: int


def _keep(buffer: collections.deque, record) -> None:
    if len(buffer) == buffer.maxlen:
        counters["trace.dropped"] = counters.get("trace.dropped", 0) + 1
    buffer.append(record)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "id", "parent", "run", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.run = getattr(_local, "run", None)
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        stack = _stack()
        if self.id in stack:
            stack.remove(self.id)
        _keep(_spans, Span(self.name, self.t0, t1, self.parent, self.run, self.attrs, self.id))
        return False


def span(name: str, **attrs):
    """The body as a span ``name`` while recording is on; else a no-op."""
    if not _on:
        return _NULL
    return _Open(name, attrs)


def spanned(name: str):
    """Decorates a function so that each call is the span ``name``."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name, {}):
                return fn(*args, **kwargs)

        return wrapper

    return decorate


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n
    if _on:
        _keep(_increments, (time.perf_counter(), name, n))


def counter(name: str) -> int:
    return counters.get(name, 0)


def reset(prefix: str = "") -> None:
    """Zeroes the counters whose names start with ``prefix``."""
    for name in [k for k in counters if k.startswith(prefix)]:
        del counters[name]


def recording() -> bool:
    return _on


def enable() -> None:
    """Recording on, into fresh buffers of ``LIMIT`` records (no-op if on)."""
    global _on, _spans, _increments
    if not _on:
        _spans = collections.deque(maxlen=LIMIT)
        _increments = collections.deque(maxlen=LIMIT)
        _on = True


def disable() -> None:
    """Recording off; what was recorded stays readable by ``since``."""
    global _on
    _on = False


@contextlib.contextmanager
def run(rid: int | None = None):
    """The body's spans belong to run ``rid``; by default to the run open
    in the thread, or to a new one."""
    prev = getattr(_local, "run", None)
    _local.run = rid or prev or next(_runs)
    try:
        yield _local.run
    finally:
        _local.run = prev


def run_steps(gen_fn):
    """A generator function whose every call is one run: each step runs
    inside it, joining the run open when the generator was first stepped."""

    @functools.wraps(gen_fn)
    def wrapper(*args, **kwargs):
        gen = gen_fn(*args, **kwargs)
        rid = None
        try:
            while True:
                with run(rid) as rid:
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
                yield item
        finally:
            gen.close()

    return wrapper


class Trace(NamedTuple):
    """Spans and counter increments of a stretch of recording."""

    spans: list
    increments: list

    def table(self) -> dict:
        """{name: (spans, seconds, self seconds)}: self seconds leave out
        the time the spans' children cover."""
        children = collections.defaultdict(float)
        for s in self.spans:
            if s.parent is not None:
                children[s.parent] += s.t1 - s.t0
        out = {}
        for s in self.spans:
            n, total, own = out.get(s.name, (0, 0.0, 0.0))
            d = s.t1 - s.t0
            out[s.name] = (n + 1, total + d, own + d - children[s.id])
        return out

    def count(self, name: str) -> int:
        return sum(n for _t, k, n in self.increments if k == name)


def since(t: float = float("-inf")) -> Trace:
    """The spans begun and the increments made at ``perf_counter()`` time
    ``t`` or later."""
    return Trace([s for s in _spans if s.t0 >= t], [i for i in _increments if i[0] >= t])


def log_summary(trace: Trace) -> None:
    """One DEBUG line per span name (count, total s, self s) and one per
    counter, in name order."""
    for name, (n, total, own) in sorted(trace.table().items()):
        logging.debug("[span] %s: %d, %.3f s, self %.3f s", name, n, total, own)
    totals = collections.Counter()
    for _t, name, n in trace.increments:
        totals[name] += n
    for name, n in sorted(totals.items()):
        logging.debug("[count] %s: %d", name, n)


def _sync(device) -> None:
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(label: str, device=None):
    """The stage's per-block tail as the span ``stage.tail`` (attr
    ``label``).  With DEBUG enabled the card is synchronised before each
    clock read, so the logged seconds hold the device work the phase
    launched."""
    if not logging.root.isEnabledFor(logging.DEBUG):
        with span("stage.tail", label=label):
            yield
        return
    _sync(device)
    t0 = time.perf_counter()
    try:
        with span("stage.tail", label=label):
            yield
    finally:
        _sync(device)
        logging.debug("[phase] %s: %.3fs", label, time.perf_counter() - t0)
