"""Each cell's unit end to end at a tiny size on the CPU, the harness's
look-up by name, and what a run may have loaded."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import CELLS, CLOCK, tiny

ROOT = harness.ROOT


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end(run_cell, cell, trace):
    result = run_cell(cell, trace=trace)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    spec = harness.Cell(cell)
    wanted = spec.per_layer if trace else spec.end_to_end
    # the device metrics read nothing on the CPU, nor do layouts built on the
    # card (the CPU's host builds them); every span metric reads
    on_device = {"sweep_roofline", "layout.device_builds_per_job"}
    assert set(result["metrics"]) == {m["name"] for m in wanted} - on_device
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_clock_alignment_runs_correct(run_cell, cell):
    result = run_cell(cell, overrides=dict(tiny(cell), **CLOCK))
    assert result["correct"] is True
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_a_cell_without_a_card_prints_nothing(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_new_configuration_mix_and_metric_are_found_by_name(tmp_path, run_cell):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cfg = json.loads((root / "benchmark/configs/bact-1mb-4096.json").read_text())
    cfg.update(name="tiny-new", samples=30, sites=6000, row_block=8, snp_threshold=150)
    (root / "benchmark/configs/tiny-new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/sweep.json").read_text())
    mix["check_units"] = 1
    (root / "benchmark/traffic/sweep-one.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/new.units_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace['units'])\n")
    spec["configs"].append({"name": "tiny-new", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/tiny-new.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny-new.sweep-one", "config": "tiny-new",
                              "traffic": "sweep-one", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "new.units_traced", "unit": "sweeps", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "sweep_pairs_per_s", "workloads": ["tiny-new.sweep-one"]})
    spec["end_to_end"][1]["workloads"].append("tiny-new.sweep-one")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.Cell("tiny-new.sweep-one", str(root))
    assert cell.config["samples"] == 30 and cell.traffic["check_units"] == 1
    assert [m["name"] for m in cell.per_layer] == ["new.units_traced"]
    result = run_cell("tiny-new.sweep-one", trace=True, root=str(root), overrides={})
    assert result["correct"] is True
    assert result["metrics"]["new.units_traced"]["value"] >= 1
    assert len(harness.Cell("tiny-new.sweep-one", str(root)).end_to_end) == 2


@pytest.mark.parametrize("cell", ["bact-1mb-10000.sweep", "bact-1mb-4096.filter-job"])
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import harness\n"
        f"r = harness.run({cell!r}, 3, 0.2, True, t0=time.perf_counter(), device='cpu',\n"
        f"                overrides={tiny(cell)!r})\n"
        "assert r is not None and r['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, check=True).stdout
    loaded = set(json.loads(out.splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "tracs_tpu"}
    assert "tracs_tpu_torch" in loaded


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["tracs_tpu_torch", "tracs_tpu_torch.ops", "jaxtyping",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["tracs_tpu.ops.pairsnp", "jax._src", "flax"]) == [
        "flax", "jax", "tracs_tpu"]


@pytest.mark.cuda
def test_the_card_reference_equals_the_cpus():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import generate
    from benchmark.reference.distances import Distances

    planes = generate.make_clustered(70, 29903, cluster_size=7, max_mut=10, n_partial_cols=500,
                                     n_share=0.14, seed=4)
    on_card = Distances(planes, 29903, torch.device("cuda")).survivors(20, block_rows=16)
    on_cpu = Distances(planes, 29903, torch.device("cpu")).survivors(20, block_rows=16)
    assert all(np.array_equal(a, b) for a, b in zip(on_card, on_cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card_at_a_small_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = harness.run(cell, 7, 0.5, True, t0=0.0, device="cuda", overrides=tiny(cell))
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
