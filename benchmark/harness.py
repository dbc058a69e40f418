"""One run of one cell: set-up, the measured window, the traced layers, and
the check against the plain references.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (its ``file``), the traffic mix
``benchmark/traffic/<traffic>.json`` and each per-layer metric's reader
``benchmark/metrics/<metric>.py``, a module whose ``read(ctx)`` returns the
number or None.  A cell, a configuration, a mix or a metric is added as new
files and entries, with no edit here.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, devtrace, generate
from benchmark.spans import Spans, installed
from benchmark.units import UNITS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tracs_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and metrics."""

    def __init__(self, name: str, root: str = ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            spec = json.load(fh)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(cells)}")
        self.root, self.name, self.spec = root, name, cells[name]
        self.chips = self.spec["chips"]
        cfg_entry = {c["name"]: c for c in spec["configs"]}[self.spec["config"]]
        with open(os.path.join(root, cfg_entry["file"])) as fh:
            self.config = json.load(fh)
        with open(os.path.join(root, "benchmark", "traffic", self.spec["traffic"] + ".json")) as fh:
            self.traffic = json.load(fh)
        mine = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    def reader(self, metric: str):
        """``read(ctx)`` of a per-layer metric's file."""
        path = os.path.join(self.root, "benchmark", "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among ``modules`` (default: loaded)."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


def _window(unit, seconds: float, keep: int, rng, recorder, spans, trace_seconds: float):
    """Units back to back until ``seconds`` have passed, the last one
    finished.  Keeps a sample of ``keep`` outputs drawn by ``rng``
    (reservoir); with a ``recorder``, profiles the units begun in the first
    ``trace_seconds``, spans every unit, and runs at least one unit with the
    profiler off.  Returns (seconds, units, kept outputs, units traced)."""
    kept, count, traced, ends = [], 0, None, []
    if recorder:
        recorder.start()
    t0 = time.perf_counter()
    while True:
        with spans.span(unit.kind) if recorder else contextlib.nullcontext():
            out = unit.run(count)
        count += 1
        ends.append(time.perf_counter() - t0)
        if len(kept) < keep:
            kept.append(out)
        else:
            j = int(rng.integers(count))
            if j < keep:
                unit.discard(kept[j])
                kept[j] = out
            else:
                unit.discard(out)
        elapsed = time.perf_counter() - t0
        if recorder and traced is None and elapsed >= trace_seconds:
            recorder.stop()
            traced = count
        if elapsed >= seconds and (not recorder or traced is not None and count > traced):
            break
    if count <= 50:
        log("# unit ends (s): " + " ".join(f"{t:.3f}" for t in ends))
    return elapsed, count, kept, traced


def run(workload: str, seed: int, seconds: float, trace: bool, *, t0: float, root: str = ROOT,
        device: str = "cuda", overrides: dict | None = None) -> dict | None:
    """One run; returns the result line as a dict, or None when the run
    cannot stand (no card, a forbidden module)."""
    cell = Cell(workload, root)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        log(f"bench: {cell.name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}")
        return None
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cfg = dict(cell.config, **(overrides or {}))
    traffic = cell.traffic
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        planes = generate.alignment(cfg, seed)
        log(f"# data made at {time.perf_counter() - t0:.3f} s")
        unit = UNITS[traffic["unit"]](cfg, traffic, planes, seed, dev, workdir)
        unit.warm()
        spans = Spans(dev)
        with installed(spans) if trace else contextlib.nullcontext():
            setup_s = time.perf_counter() - t0
            log(f"# {cell.name} seed {seed}: set-up {setup_s:.3f} s")
            recorder = devtrace.Recorder(dev) if trace else None
            elapsed, count, kept, traced = _window(
                unit, seconds, traffic["check_units"], np.random.default_rng([seed, 1]), recorder,
                spans, traffic["trace_seconds"])
        unit.finish()
        log(f"# window {elapsed:.3f} s, {count} {traffic['unit']}s")
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        result = {"correct": False, "attempted": count, "failed": 0, "metrics": {},
                  "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                             "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                             "count": cell.chips, "memory_peak_bytes": memory_peak}}
        if trace:
            summary = recorder.summary(spans, traced)
            result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            # the span metrics read only the units that ran with the profiler off
            ctx = SimpleNamespace(config=cfg, unit=traffic["unit"], units=count - traced,
                                  spans=spans.since(recorder.t1), trace=summary, planes=planes,
                                  outputs=kept)
            times = spans.seconds[unit.kind]
            if count > traced:
                log(f"# {traced} {traffic['unit']}s profiled, {np.mean(times[:traced]):.3f} s "
                    f"each; {count - traced} not, {np.mean(times[traced:]):.3f} s each")
            for m in cell.per_layer:
                value = cell.reader(m["name"])(ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        else:
            measured = dict(unit.metrics(elapsed, count), setup_s=(setup_s, "s"))
            for m in cell.end_to_end:
                value, unit_name = measured[m["name"]]
                result["metrics"][m["name"]] = {"value": value, "unit": unit_name}
        # the program's state leaves the card before the reference runs
        unit.close()
        del unit
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = judge(cfg, traffic, planes, seed, kept, dev)
        log(f"# reference and comparison {time.perf_counter() - t_check:.3f} s")
        result["correct"] = bool(kept) and all(c["value"] <= c["limit"] for c in checks.values())
        log(f"# checked {len(kept)} of the window's {count} {traffic['unit']}s")
        for name, c in checks.items():
            log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
        result["checks"] = checks
        bad = forbidden_modules()
        if bad:
            log(f"bench: the run loaded {bad}")
            return None
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def judge(cfg: dict, traffic: dict, planes, seed: int, kept: list, dev) -> dict:
    """{name: {value, limit}} of the numbers compared."""
    meta, filtered = traffic.get("meta", False), traffic.get("filter", False)
    days = generate.sample_days(cfg["samples"], cfg["cluster_size"], seed) if meta else None
    exp = check.Expected(cfg, planes, days, dev, filtered=filtered)
    if traffic["unit"] == "sweep":
        values = check.sweep_checks(kept, exp)
    else:
        values = check.job_checks([check.read_job_csv(p) for p in kept], exp, cfg["name"],
                                  meta, filtered)
    return {k: {"value": v, "limit": traffic["limits"][k]} for k, v in values.items()}
