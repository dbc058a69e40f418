"""The per-layer metric ``filter.keep_table_sf_evals_per_job``: a whole
positive count a job in a traced filter job on the CPU, no more than a
bisection of each table's rows takes, absent from a job without the filter,
and None for a program that keeps no such counter."""

from types import SimpleNamespace

import pytest

from benchmark import harness

METRIC = "filter.keep_table_sf_evals_per_job"


@pytest.fixture
def fresh_counters():
    """The stage's and filter's counters from zero, as in a new process."""
    from tracs_tpu_torch.runtime import profiling

    for prefix in ("stage.", "filter."):
        profiling.reset(prefix)
    return profiling


def test_a_filter_job_reads_a_whole_count_within_a_bisection(run_cell, fresh_counters):
    result = run_cell("bact-1mb-4096.filter-job", trace=True)
    assert result["correct"] is True
    evals = result["metrics"][METRIC]["value"]
    tables = result["metrics"]["filter.keep_table_builds_per_job"]["value"]
    # every job builds the same tables cold; a row bisects over at most
    # 2 * _WIN_MAX + 3 answers, 14 steps
    assert evals > 0 and evals == int(evals)
    assert tables <= evals <= 15 * 14 * tables


def test_a_job_without_the_filter_leaves_it_out(run_cell, fresh_counters):
    result = run_cell("bact-1mb-4096.job", trace=True)
    assert METRIC not in result["metrics"]


def test_a_program_without_the_counter_reads_none(fresh_counters):
    fresh_counters.count("stage.runs")
    ctx = SimpleNamespace(unit="job", units=1)
    assert harness.Cell("bact-1mb-4096.filter-job").reader(METRIC)(ctx) is None
