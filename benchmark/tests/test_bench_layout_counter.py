"""``layout.device_builds_per_job``: split layouts built on the card over the
stage's runs, read from the program's counter ``layout.device_builds``; on
the CPU, where the host builds every layout, and on a program without the
counter it reads nothing."""

from types import SimpleNamespace

import pytest

from benchmark import harness

METRIC = "layout.device_builds_per_job"


@pytest.mark.parametrize("unit,builds,runs,want", [("job", 6, 6, 1.0), ("job", 0, 5, 0.0),
                                                   ("sweep", 1, 0, None)])
def test_the_metric_reads_layouts_a_job(monkeypatch, unit, builds, runs, want):
    from tracs_tpu_torch.runtime import profiling

    monkeypatch.setattr(profiling, "counters", {"stage.runs": runs,
                                                "layout.device_builds": builds})
    reader = harness.Cell("bact-1mb-4096.job").reader(METRIC)
    assert reader(SimpleNamespace(unit=unit, units=3)) == want


def test_a_program_without_the_counter_reads_none(monkeypatch):
    from tracs_tpu_torch.runtime import profiling

    monkeypatch.setattr(profiling, "counters", {"stage.runs": 4})
    reader = harness.Cell("bact-1mb-4096.filter-job").reader(METRIC)
    assert reader(SimpleNamespace(unit="job", units=3)) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader(SimpleNamespace(unit="job", units=3)) is None


def test_a_cpu_job_cell_builds_no_layout_on_a_card(run_cell):
    from tracs_tpu_torch.runtime import profiling

    for prefix in ("stage.", "layout."):
        profiling.reset(prefix)
    result = run_cell("bact-1mb-4096.job", trace=True)
    assert result["correct"] is True
    assert METRIC not in result["metrics"]
    assert profiling.counter("layout.device_builds") == 0
