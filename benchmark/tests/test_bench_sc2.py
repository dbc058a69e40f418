"""The SARS-CoV-2 surveillance sweep (``sc2-30kb-32768.sweep``) at a tiny size
on the CPU: its configuration is a clock alignment, the cell reads correct
and its control does not, and the sweep driver's counter metrics read the
program's counters a sweep."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, generate, harness
from benchmark.reference.distances import Distances
from benchmark.tests.conftest import tiny

CELL = "sc2-30kb-32768.sweep"
#: the configuration's genome at its full 29,903 sites, few samples and
#: row blocks of 32, so that a CPU run sweeps three blocks
TINY = tiny(CELL)
SWEEP_METRICS = ("sweep.survivors_per_sweep", "sweep.copied_bytes_per_sweep")


@pytest.fixture
def fresh_sweep_counters():
    """The sweep's counters from zero, as in a new process."""
    from tracs_tpu_torch.runtime import profiling

    profiling.reset("sweep.")
    return profiling


def _config() -> dict:
    with open(os.path.join(harness.ROOT, "benchmark", "configs", "sc2-30kb-32768.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_reads_correct_at_a_tiny_size(run_cell, trace):
    result = run_cell(CELL, trace=trace, overrides=TINY)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    spec = harness.Cell(CELL)
    wanted = spec.per_layer if trace else spec.end_to_end
    # the roofline reads busy time, which the CPU has none of
    assert set(result["metrics"]) == {m["name"] for m in wanted} - {"sweep_roofline"}


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_control_is_not_correct(seed):
    checks = control.control(harness.Cell(CELL), seed, torch.device("cpu"), TINY)
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_the_configuration_is_a_clock_alignment_without_max_mutations():
    cfg = _config()
    assert cfg["structure"] == "clock" and "max_mutations" not in cfg
    assert cfg["reduced"] == {} and cfg["sites"] == 29903
    assert set(cfg["assumed"]) == set(cfg["assumed_why"])
    assert harness.Cell(CELL).config == cfg
    planes = generate.alignment(dict(cfg, **TINY), 2**31 + 3)
    assert planes.shape == (90, 4, 935)
    with pytest.raises(ValueError, match="max_mutations"):
        generate.alignment(dict(cfg, **TINY, max_mutations=90), 2**31 + 3)


def test_the_counter_metrics_read_one_sweeps_survivors(run_cell, fresh_sweep_counters):
    seed = 2**31 + 5
    result = run_cell(CELL, seed=seed, trace=True, overrides=TINY)
    counters = fresh_sweep_counters.counters
    # the two warm-ups and every sweep of the window, each the same sweep
    assert counters["sweep.runs"] == result["attempted"] + 2
    survivors = result["metrics"]["sweep.survivors_per_sweep"]["value"]
    copied = result["metrics"]["sweep.copied_bytes_per_sweep"]["value"]
    assert survivors == counters["sweep.survivors"] / counters["sweep.runs"]
    assert copied == counters["sweep.copied_bytes"] / counters["sweep.runs"]
    cfg = dict(_config(), **TINY)
    rows = Distances(generate.alignment(cfg, seed), cfg["sites"],
                     torch.device("cpu")).survivors(cfg["snp_threshold"])[0]
    assert survivors == len(rows) > 0 and copied == 16 * survivors


def test_the_counter_metrics_read_none_without_sweep_runs(monkeypatch, fresh_sweep_counters):
    cell = harness.Cell(CELL)
    fresh_sweep_counters.count("sweep.runs", 2)
    fresh_sweep_counters.count("sweep.survivors", 10)
    fresh_sweep_counters.count("sweep.copied_bytes", 160)
    sweep, job = SimpleNamespace(unit="sweep"), SimpleNamespace(unit="job")
    assert [cell.reader(m)(sweep) for m in SWEEP_METRICS] == [5.0, 80.0]
    assert [cell.reader(m)(job) for m in SWEEP_METRICS] == [None, None]
    monkeypatch.delitem(fresh_sweep_counters.counters, "sweep.runs")
    assert [cell.reader(m)(sweep) for m in SWEEP_METRICS] == [None, None]
    monkeypatch.delattr(fresh_sweep_counters, "counters")
    assert [cell.reader(m)(sweep) for m in SWEEP_METRICS] == [None, None]
