"""runtime/profiling.py on the CPU: ``trace`` writes a Chrome trace into the
directory it is given and nothing without one (tracs_tpu reads the
directory from ``TRACS_TPU_PROFILE``); ``phase`` logs a phase's seconds and
takes a device; ``rate_logger`` accumulates."""

import json
import logging
import os

import torch

from tracs_tpu_torch.runtime import profiling


def test_trace_writes_a_chrome_trace_into_the_given_directory(tmp_path):
    with profiling.trace("unit", tmp_path / "traces") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "traces")
    assert files == [f"unit.{os.getpid()}.trace.json"]
    with open(tmp_path / "traces" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in row.key for row in prof.key_averages())


def test_trace_without_a_directory_records_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace("unit") as prof:
        torch.ones(4) + 1
    assert prof is None and os.listdir(tmp_path) == []


def test_phase_logs_its_seconds_and_takes_a_device(caplog):
    caplog.set_level(logging.DEBUG)
    with profiling.phase("unit work", torch.device("cpu")):
        torch.ones(8).sum()
    with profiling.phase("no device"):
        pass
    lines = [r.getMessage() for r in caplog.records]
    assert any(ln.startswith("[phase] unit work: ") and ln.endswith("s") for ln in lines)
    assert any(ln.startswith("[phase] no device: ") for ln in lines)


def test_rate_logger_accumulates(caplog):
    caplog.set_level(logging.DEBUG)
    log = profiling.rate_logger("pairs")
    log(10)
    log(5)
    assert "[rate] 15 pairs in" in caplog.records[-1].getMessage()
