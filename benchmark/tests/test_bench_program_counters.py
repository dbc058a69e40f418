"""The per-layer metrics read from the program's own counters: what they
read in a traced job cell on the CPU, that a program without the counters
reads None, and that a run leaves the program's span recording off."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness

COUNTER_METRICS = {"meta.k_steps_per_job": "bact-1mb-4096.job",
                   "meta.lanes_per_job": "bact-1mb-4096.job",
                   "filter.keep_table_builds_per_job": "bact-1mb-4096.filter-job"}


@pytest.fixture
def fresh_counters():
    """The stage's, model's and filter's counters from zero, as in a new
    process."""
    from tracs_tpu_torch.runtime import profiling

    for prefix in ("stage.", "meta.", "filter."):
        profiling.reset(prefix)
    return profiling


@pytest.mark.parametrize("cell", ["bact-1mb-4096.job", "bact-1mb-4096.filter-job"])
def test_the_counter_metrics_read_whole_counts_a_job(run_cell, fresh_counters, cell):
    result = run_cell(cell, trace=True)
    wanted = {m for m, c in COUNTER_METRICS.items() if c == cell or cell.endswith("filter-job")}
    for name in wanted:
        value = result["metrics"][name]["value"]
        # every job of a run is the same job, cold: each counts the same
        assert value > 0 and value == int(value), (name, value)
    assert fresh_counters.counter("stage.runs") == result["attempted"] + 1  # and the warm-up
    if cell.endswith(".job"):
        assert "filter.keep_table_builds_per_job" not in result["metrics"]


def test_a_program_without_the_counters_reads_none(monkeypatch):
    from tracs_tpu_torch.runtime import profiling

    monkeypatch.delattr(profiling, "counters")
    ctx = SimpleNamespace(unit="job", units=3)
    cell = harness.Cell("bact-1mb-4096.filter-job")
    assert all(cell.reader(name)(ctx) is None for name in COUNTER_METRICS)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_leaves_span_recording_off(run_cell, trace):
    from tracs_tpu_torch.runtime import profiling

    t0 = time.perf_counter()
    result = run_cell("bact-1mb-4096.filter-job", trace=trace)
    assert result["correct"] is True
    assert not profiling.recording()
    assert profiling.since(t0).spans == []
