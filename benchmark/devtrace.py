"""The device trace of a traced run: ``torch.profiler`` over the first units of
the window, recording the card's activity alone (no host operators, so the
host work runs at its own speed), reduced to the device's busy seconds (the
union of every kernel, copy and memset interval), the traced window's
length, the device operations that took most time, and the idle gaps put
down to the innermost span the host was in (spans.py).

The host's clock and the trace's are tied by a marker: with the card idle,
the host reads its clock and launches one small kernel, the trace's first
device event."""

from __future__ import annotations

import time
from collections import defaultdict

import torch

_TOP = 10


class Recorder:
    """Starts and stops the profiler; ``summary`` reads what it recorded."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.start()
        self._sync()
        self.t0 = time.perf_counter()
        torch.zeros(1, device=self.device)  # the marker
        self._sync()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def _device_events(self) -> list:
        """[(start, end, name)] in the trace's microseconds."""
        events = [(e.time_range.start, e.time_range.end, e.name) for e in self.prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events and self.device.type == "cuda":
            raise RuntimeError("the profiler recorded no device activity, not even the marker")
        return events

    def summary(self, spans, units: int) -> dict:
        """{busy_s, window_s, units, device_ops, idle_gaps}."""
        device = sorted(self._device_events())
        # microseconds of the trace at the host's perf_counter() = 0
        offset = device[0][0] - self.t0 * 1e6 if device else -self.t0 * 1e6
        w0, w1 = self.t0 * 1e6 + offset, self.t1 * 1e6 + offset
        by_name = defaultdict(float)
        busy = []
        for s, e, name in device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            by_name[name] += (e - s) * 1e-6
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        host = [(t0 * 1e6 + offset, t1 * 1e6 + offset, name)
                for name, t0, t1 in spans.intervals if t1 >= self.t0 and t0 <= self.t1]
        edges = [w0] + [x for b in busy for x in b] + [w1]
        idle = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        gaps = defaultdict(float)
        for (s, e), label in zip(idle, _labels([(s + e) / 2 for s, e in idle], host)):
            gaps["idle in " + label] += (e - s) * 1e-6
        top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]
        return {"busy_s": sum(e - s for s, e in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
                "units": units, "device_ops": top(by_name), "idle_gaps": top(gaps)}


def _labels(times, spans) -> list:
    """For each of the ascending ``times``, the innermost (latest begun) span
    open at it."""
    spans = sorted(spans)
    out, open_, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            open_.append(spans[k])
            k += 1
        open_ = [h for h in open_ if h[1] >= t]
        out.append(open_[-1][2] if open_ else "outside the spans")
    return out
