"""The sweep's bound, recomputed by hand from bact-1mb-10000.sweep's shapes,
and the partial sites it counts."""

import json
import os

import numpy as np
import pytest

from benchmark import generate, roofline
from benchmark.tests.conftest import mixtures, rebuilt_mixtures

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_peaks_are_chip_smokes():
    assert roofline.PEAK_INT8 == 1979e12
    assert roofline.PEAK_B1 == 8 * 1979e12
    assert roofline.PEAK_BYTES == 3.35e12


def test_bact_sweep_bound_by_hand():
    with open(os.path.join(ROOT, "benchmark", "configs", "bact-1mb-10000.json")) as fh:
        cfg = json.load(fh)
    n, L, partial = cfg["samples"], cfg["sites"], cfg["partial_columns"]
    assert (n, L, partial) == (10_000, 1_000_000, 2048)
    pairs = 10_000 * 9_999 // 2  # 49,995,000 unique pairs
    assert pairs == 49_995_000
    # 5 single-bit products a site and 10 a partial site, 2 operations each
    ops = 2 * pairs * (5 * 1_000_000 + 10 * 2048)
    assert ops == 501_997_795_200_000
    survivors = 476 * 21 * 20 // 2 + 4 * 3 // 2  # 476 whole clusters of 21 and one of 4
    assert survivors == 99_966
    bytes_moved = 10_000 * 4 * 31_250 * 4 + 16 * survivors
    assert roofline.sweep_work(n, L, partial, survivors) == (ops, bytes_moved)
    seconds, by = roofline.sweep_bound(n, L, partial, survivors)
    # the b1 operations bind: 31.7 ms against 1.49 ms of bytes
    assert by == "operations"
    assert abs(seconds - ops / (8 * 1979e12)) < 1e-12
    assert abs(seconds - 31.70779e-3) < 1e-8
    assert bytes_moved / 3.35e12 < seconds / 20


def test_bound_picks_the_larger():
    assert roofline.bound(3.35e12, 1.0, 1e12) == (1.0, "bytes")
    assert roofline.bound(1.0, 2e12, 1e12) == (2.0, "operations")


def test_partial_sites_count_the_generated_columns():
    planes = generate.make_clustered(40, 5000, cluster_size=6, max_mut=20, n_partial_cols=300,
                                     n_share=0.14, seed=3)
    assert roofline.partial_sites(planes) == 300
    none = generate.make_clustered(40, 5000, cluster_size=6, max_mut=20, n_partial_cols=0,
                                   n_share=0.14, seed=3)
    assert roofline.partial_sites(none) == 0


@pytest.mark.parametrize("strains,partial", [(2, 0), (2, 300), (3, 300)])
def test_partial_sites_of_mixtures_are_where_mixed_strains_differ(strains, partial):
    """The union, over the mixed samples, of the sites where their strains'
    bases differ and their own N does not lie, with the M/R columns."""
    cfg = mixtures(samples=90, sites=5000, cluster_size=6, max_mutations=20,
                   partial_columns=partial, n_share=0.14, strains=strains)
    want = rebuilt_mixtures(cfg, 2**31 + 23)
    bits = np.unpackbits(want.mixed[:, :, None], axis=-1).sum(axis=-1)
    differ = ((bits >= 2) & ~want.is_n).any(axis=0)
    assert differ.sum() > 100
    expected = int((differ | want.partial).sum())
    assert roofline.partial_sites(generate.alignment(cfg, 2**31 + 23)) == expected
