"""Shared pieces of the benchmark's tests: tiny sizes of each configuration,
the clock structure as an override, and one harness run of a cell on the
CPU."""

import time

import pytest

TINY = {"bact-1mb-10000": {"samples": 90, "sites": 29903, "row_block": 32},
        "bact-1mb-4096": {"samples": 48, "sites": 20000, "row_block": 16}}
CELLS = ["bact-1mb-10000.sweep", "bact-1mb-4096.job", "bact-1mb-4096.filter-job"]
#: the generator's clock structure at SARS-CoV-2's 29,903 sites and upstream's
#: default clock rate, as an override of a cell's configuration
CLOCK = {"structure": "clock", "max_mutations": None, "sites": 29903, "cluster_size": 21,
         "clock_rate": 29.903000000000002}


def tiny(cell: str) -> dict:
    return TINY[cell.split(".")[0]]


@pytest.fixture
def run_cell(monkeypatch):
    from benchmark import harness

    # the test process holds jax and tracs_tpu for the reference tests; the
    # rule itself is tested in a fresh process (test_bench_cells.py)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def run(cell, seed=2**31 + 5, seconds=0.2, trace=False, **kw):
        if "overrides" not in kw:
            kw["overrides"] = tiny(cell)
        return harness.run(cell, seed, seconds, trace, t0=time.perf_counter(), device="cpu", **kw)
    return run
