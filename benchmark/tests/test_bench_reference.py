"""The benchmark's plain references against the JAX package ``tracs_tpu`` on
the CPU at small sizes: D, NN, the filtered distance, p0 and E(K).  This file
imports jax; the references never do."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from benchmark import generate  # noqa: E402
from benchmark.reference import recomb, transmission  # noqa: E402
from benchmark.reference.distances import Distances  # noqa: E402
from benchmark.tests.conftest import mixtures, rebuilt_mixtures  # noqa: E402


def _mixtures(n, length, **changes) -> dict:
    return mixtures(samples=n, sites=length, max_mutations=60, partial_columns=200,
                    n_share=0.14, **changes)


def _planted(n, length, seed, structure="clusters"):
    """A clustered or mixtures alignment with a dense substitution tract on
    every fourth sample, so that the filter drops sites."""
    if structure == "clusters":
        planes = generate.make_clustered(n, length, cluster_size=7, max_mut=60,
                                         n_partial_cols=200, n_share=0.14, seed=seed)
    else:
        planes = generate.alignment(_mixtures(n, length), seed)
    rng = np.random.default_rng(seed)
    for i in range(0, n, 4):
        pos = length // 3 + rng.choice(300, 30, replace=False)
        w, b = pos // 32, (pos % 32).astype(np.uint32)
        for c in range(4):
            np.bitwise_and.at(planes[i, c], w, ~(np.uint32(1) << b))
        np.bitwise_or.at(planes[i, 3], w, np.uint32(1) << b)
    return planes


@pytest.mark.parametrize("n,length,dist,seed,structure", [
    pytest.param(40, 20000, 150, 1, "clusters", id="40-20000-150-1"),
    pytest.param(35, 29903, 20, 2, "clusters", id="35-29903-20-2"),
    pytest.param(28, 5000, 10**9, 3, "clusters", id="28-5000-1000000000-3"),
    pytest.param(42, 20000, 300, 4, "mixtures", id="mixtures-42-20000-300-4")])
def test_distances_and_filter_equal_tracs_tpu(n, length, dist, seed, structure):
    from tracs_tpu.ops.packing import PackedAlignment
    from tracs_tpu.ops.pairsnp import pairsnp

    planes = _planted(n, length, seed, structure)
    ref = Distances(planes, length, "cpu", site_chunk=4096)
    rows, cols, d, nn = ref.survivors(dist, block_rows=16)
    pair, site = ref.mismatch_positions(rows, cols)
    filt = recomb.filtered_distances(pair, site, len(rows), length)
    packed = PackedAlignment(planes=planes.copy(), length=length, names=[str(i) for i in range(n)])
    j_rows, j_cols, j_d, _names, j_filt, j_nn = pairsnp([packed], dist=dist, filter=True)
    for ours, theirs in ((rows, j_rows), (cols, j_cols), (d, j_d), (nn, j_nn), (filt, j_filt)):
        assert np.array_equal(ours, np.asarray(theirs, dtype=np.int64))
    assert (filt < d).any(), "the planted tracts leave the filter nothing to drop"


@pytest.mark.parametrize("strains", [2, 3])
@pytest.mark.parametrize("seed", [5, 2**31 + 19])
def test_a_mixture_is_at_distance_0_from_each_strain_it_carries(seed, strains):
    """By the reference, every mixed sample lies at D 0 from each donor
    whose strain it carries, and the pairs of different clusters that no
    mixture joins lie far apart."""
    cfg = _mixtures(60, 20000, strains=strains)
    planes = generate.alignment(cfg, seed)
    d, nn = Distances(planes, cfg["sites"], "cpu", site_chunk=4096).block(0, cfg["samples"])
    draws = rebuilt_mixtures(cfg, seed).draws
    donors = draws.donors
    mixed = np.repeat(draws.mixed, donors.shape[1])
    assert (d[mixed, donors.reshape(-1)] == 0).all() and (nn[mixed, donors.reshape(-1)] > 0).all()
    assert (d[donors.reshape(-1), mixed] == 0).all()
    cluster = np.arange(cfg["samples"]) // cfg["cluster_size"]
    joined = np.zeros(d.shape, dtype=bool)
    joined[mixed, :] = joined[:, mixed] = True
    apart = (cluster[:, None] != cluster[None, :]) & ~joined
    assert apart.any() and (d[apart] > 100).all()


def test_transmission_model_equals_tracs_tpu():
    from tracs_tpu.models.transcluster import trans_dist

    rng = np.random.default_rng(5)
    snps = rng.integers(0, 200, 3000)
    years = transmission.years_apart(rng.integers(0, 181, 3000), 0)
    for lamb, beta, thr in ((29.903000000000002, 73.0, 0.01), (5.0, 20.0, 0.01)):
        log_p0, ek = transmission.trans_dist(snps, years, lamb, beta, thr)
        j_p0, j_ek = (np.asarray(x) for x in trans_dist(snps, years, lamb, beta, thr))
        np.testing.assert_allclose(np.exp(log_p0), np.exp(j_p0), rtol=1e-9, atol=0)
        np.testing.assert_allclose(ek, j_ek, rtol=1e-9, atol=0)


def test_years_equal_the_stage_arithmetic():
    from datetime import date, timedelta

    days = np.array([0, 17, 180, 1000, 1095])
    secs = np.array([((date(2019, 1, 1) + timedelta(days=int(x))) - date(1970, 1, 1))
                     .total_seconds() for x in days])
    stage = np.abs(secs[:, None] - secs[None, :]) / 31556952.0
    assert np.array_equal(transmission.years_apart(days[:, None], days[None, :]), stage)
