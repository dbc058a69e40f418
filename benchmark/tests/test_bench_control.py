"""``correct`` comes out false for the control and for each fault a cell can
have, planted under a whole run (the harness's look for a card skipped)."""

import numpy as np
import pytest
import torch

from benchmark import control, generate, harness, roofline
from benchmark.tests.conftest import CELLS, CLOCK, MIXTURES, tiny


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    checks = control.control(harness.Cell(cell), seed, torch.device("cpu"), tiny(cell))
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_a_clock_alignment_is_not_correct(cell, seed):
    overrides = dict(tiny(cell), **CLOCK)
    assert harness.Cell(cell).config["partial_columns"] > 0
    checks = control.control(harness.Cell(cell), seed, torch.device("cpu"), overrides)
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_control_on_a_mixtures_alignment_is_not_correct(seed):
    """With no M/R columns the mixtures alone bite: two mixed samples that
    carry the same two strains hold equal 2-bit codes where the strains
    differ, and the control counts each such site twice."""
    cell = "bact-1mb-10000.sweep"
    overrides = dict(tiny(cell), **MIXTURES, partial_columns=0)
    assert roofline.partial_sites(generate.alignment(dict(harness.Cell(cell).config,
                                                          **overrides), seed)) > 0
    checks = control.control(harness.Cell(cell), seed, torch.device("cpu"), overrides)
    assert any(c["value"] > c["limit"] for c in checks.values())


def _broken_extract(mode):
    from tracs_tpu_torch.ops import pairsnp

    real = pairsnp._extract_coo

    def extract(grams, L, dist, r0, n_valid, c0, *, triangle):
        rows, cols, d, nn = real(grams, L, dist, r0, n_valid, c0, triangle=triangle)
        if mode == "half the batch left out" and (r0 // max(1, grams_rows(grams))) % 2:
            keep = np.zeros(len(rows), dtype=bool)
            return rows[keep], cols[keep], d[keep], nn[keep]
        if mode == "a distance altered" and len(d):
            d = d.copy()
            d[0] += 1
        if mode == "a site count altered" and len(nn):
            nn = nn.copy()
            nn[-1] -= 1
        return rows, cols, d, nn
    return extract


def grams_rows(grams) -> int:
    return next(iter(v for v in grams.values() if hasattr(v, "shape"))).shape[0]


SWEEP_FAULTS = ["half the batch left out", "a distance altered", "a site count altered"]
JOB_FAULTS = SWEEP_FAULTS + ["p0 altered", "E(K) altered"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in (SWEEP_FAULTS if c.endswith("sweep")
                                                  else JOB_FAULTS)]
                         + [("bact-1mb-4096.filter-job", "a filtered distance altered")])
def test_a_planted_fault_is_not_correct(monkeypatch, run_cell, cell, fault):
    from tracs_tpu_torch.models import transcluster
    from tracs_tpu_torch.ops import pairsnp

    assert run_cell(cell)["correct"] is True
    if fault in SWEEP_FAULTS:
        monkeypatch.setattr(pairsnp, "_extract_coo", _broken_extract(fault))
    elif fault == "a filtered distance altered":
        real_filter = pairsnp.filter_pairs
        monkeypatch.setattr(pairsnp, "filter_pairs",
                            lambda *a, **k: real_filter(*a, **k) + (np.arange(len(a[2])) == 0))
    else:
        real_model = transcluster.trans_dist
        k = 0 if fault == "p0 altered" else 1

        def model(*a, **kw):
            out = list(real_model(*a, **kw))
            out[k] = out[k] * (1 + 1e-5)
            return tuple(out)
        monkeypatch.setattr(transcluster, "trans_dist", model)
    try:
        result = run_cell(cell)
    except AssertionError:
        # the filter's own check of its mismatch counts against the distances
        # stops the run: no result line, which the check counts as a failure
        assert cell.endswith("filter-job") and "distance" in fault
        return
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
