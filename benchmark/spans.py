"""Spans of a traced run, taken from the benchmark's side: host-clock timers
around the program's layer entry functions, installed where the program's
modules look those functions up, so no file of the program changes.

Each timer synchronises the card before and after its call, so a span holds
the device work the call launched.  Each span's interval on the host's clock
is kept too: the device trace puts its idle gaps down to them (devtrace.py).

  layout      ops/pairsnp.py -> compact_variant_columns, split_alignment
  filter      ops/pairsnp.py -> filter_pairs (the recombination filter)
  meta        stages/distance.py -> TransClusterCache.lookup (the model)
  stage_tail  stages/distance.py -> phase("block rows [r0,r1)"): the stage's
              per-block years, lookup, CSV, write and cursor
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import torch


class Spans:
    """Durations by span name, and every span's (name, start, end)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = defaultdict(list)
        self.intervals = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            t1 = time.perf_counter()
            self.seconds[name].append(t1 - t0)
            self.intervals.append((name, t0, t1))

    def timed(self, name: str, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapper

    def since(self, t: float) -> "Spans":
        """The spans begun at host time ``t`` or later."""
        out = Spans(self.device)
        for name, t0, t1 in self.intervals:
            if t0 >= t:
                out.seconds[name].append(t1 - t0)
                out.intervals.append((name, t0, t1))
        return out

    def total(self, name: str) -> float | None:
        """Seconds of every span of that name; None if it never ran."""
        return sum(self.seconds[name]) if self.seconds.get(name) else None


@contextlib.contextmanager
def installed(spans: Spans):
    """Wraps the layer entry points in timers for the body's duration."""
    from tracs_tpu_torch.ops import pairsnp
    from tracs_tpu_torch.stages import distance

    cache_cls = distance.TransClusterCache

    class TimedCache(cache_cls):
        lookup = spans.timed("meta", cache_cls.lookup)

    @contextlib.contextmanager
    def phase(label, device=None):
        with spans.span("stage_tail"):
            yield

    patches = [(pairsnp, "compact_variant_columns", spans.timed("layout", pairsnp.compact_variant_columns)),
               (pairsnp, "split_alignment", spans.timed("layout", pairsnp.split_alignment)),
               (pairsnp, "filter_pairs", spans.timed("filter", pairsnp.filter_pairs)),
               (distance, "TransClusterCache", TimedCache),
               (distance, "phase", phase)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, new in patches:
            setattr(mod, name, new)
        yield spans
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)
