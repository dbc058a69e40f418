"""The benchmark's generator: the copied clusters and dates equal the
program's originals, the existing configurations' planes are pinned, the
clock structure follows its clock, and the mixtures structure's codes are
its strains' bases."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

from benchmark import generate
from benchmark.tests.conftest import mixtures, rebuilt_mixtures

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("n,length,cluster,max_mut,partial", [
    (50, 1000, 6, 90, 2048), (64, 3333, 7, 10, 100), (100, 20000, 21, 90, 2048),
    (33, 29903, 21, 10, 2048), (21, 64, 21, 90, 0)])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_make_clustered_equals_the_ports(n, length, cluster, max_mut, partial, seed):
    from tracs_tpu_torch.experiments.workload import make_clustered

    ours = generate.make_clustered(n, length, cluster_size=cluster, max_mut=max_mut,
                                   n_partial_cols=partial, n_share=0.14, seed=seed)
    theirs = make_clustered(n, length, cluster_size=cluster, max_mut=max_mut,
                            n_partial_cols=partial, seed=seed).planes
    assert np.array_equal(ours, theirs)


def test_n_share_is_a_parameter():
    none = generate.random_planes(4, 4096, 0.0, 1)
    all4 = none[:, 0] & none[:, 1] & none[:, 2] & none[:, 3]
    assert not all4.any()
    some = generate.random_planes(4, 4096, 0.5, 1)
    share = np.unpackbits((some[:, 0] & some[:, 1] & some[:, 2] & some[:, 3]).view(np.uint8)).mean()
    assert 0.45 < share < 0.55


@pytest.mark.parametrize("n,L,n_share", [(3, 29903, 0.03125), (1030, 100, 0.14), (5, 64, 0.5),
                                         (40, 2_000_000, 0.05)])
def test_n_sites_are_the_uint8_draws_below_the_share(n, L, n_share):
    """Each sample's N are the sites whose byte of one uint8 draw a row
    (1,024 rows a draw) lies below n_share x 256, and the generator goes on
    from where those draws leave it, whatever rows it draws together."""
    W = -(-L // 32)
    planes = np.zeros((n, 4, W), np.uint32)
    rng, again = np.random.default_rng(5), np.random.default_rng(5)
    generate._n_sites(planes, rng, L, n_share)
    byte = np.concatenate([again.integers(0, 256, size=(min(1024, n - lo), W * 32), dtype=np.uint8)
                           for lo in range(0, n, 1024)])
    is_n = generate.planes_to_nibbles(planes, L) == 15
    assert np.array_equal(is_n, byte[:, :L] < round(n_share * 256))
    assert (generate.planes_to_nibbles(planes, L) % 15 == 0).all()
    assert rng.integers(0, 2**62) == again.integers(0, 2**62)


@pytest.mark.parametrize("n,cluster,seed", [(50, 6, 0), (100, 21, 2**31 + 9), (7, 3, 12)])
def test_write_dates_equals_chip_smokes(tmp_path, n, cluster, seed):
    sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.write_dates(str(tmp_path / "a.csv"), n, cluster, seed)
    generate.write_dates(str(tmp_path / "b.csv"), n, cluster, seed)
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


#: sha256 of ``alignment``'s planes at each configuration's ``conftest.TINY``
#: size: the bact ones taken before the generator had a ``structure`` key,
#: the sc2 ones before it had the mixtures structure
PINNED = {
    ("bact-1mb-10000", 3): "9d000a16026c21737b19e20c944d3196e66c296c6bbed315763c151929ba6c20",
    ("bact-1mb-10000", 2**31 + 5):
        "f98c6d4e61a34badde6921d50038a2193bfd653c849aea175fb185d2239bf07b",
    ("bact-1mb-4096", 3): "75422235be2b5b81b9ee5189e91a3300cc55850cfc35aeabb19f71bcb6e80192",
    ("bact-1mb-4096", 2**31 + 5):
        "87f6a4ecba7a1610a8dbf756dfa1ad845f11262dd9d00b418066f27e02dcbb89",
    ("sc2-30kb-32768", 3): "2e701d53677e284d58ca4f9bed41ac810da31fb79fe2b2cba423e9de5ce19400",
    ("sc2-30kb-32768", 2**31 + 5):
        "1dc45c8608aa70da5023c52bb42ec5057208ed5d8cdb9a901637bb67e26d9b4e",
}


def _config(name: str, **changes) -> dict:
    from benchmark.tests.conftest import TINY

    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as fh:
        return dict(json.load(fh), **TINY[name], **changes)


def _sha(planes) -> str:
    return hashlib.sha256(planes.tobytes()).hexdigest()


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_the_configurations_planes_are_pinned(name, seed):
    assert _sha(generate.alignment(_config(name), seed)) == PINNED[name, seed]


@pytest.mark.parametrize("name", ["bact-1mb-10000", "bact-1mb-4096"])
def test_the_clusters_structure_is_the_default(name):
    assert np.array_equal(generate.alignment(_config(name, structure="clusters"), 3),
                          generate.alignment(_config(name), 3))


def _clock(**changes) -> dict:
    cfg = {"samples": 60, "sites": 3000, "cluster_size": 7, "clock_rate": 29.903,
           "partial_columns": 40, "n_share": 0.14, "structure": "clock"}
    return dict(cfg, **changes)


def test_a_clock_alignment_is_made_from_its_seed():
    a, b = generate.alignment(_clock(), 11), generate.alignment(_clock(), 11)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, generate.alignment(_clock(), 12))


@pytest.mark.parametrize("seed", [4, 2**31 + 11])
def test_a_clock_alignment_is_its_root_its_substitutions_and_its_own_n(seed):
    cfg = _clock()
    n, L, cs = cfg["samples"], cfg["sites"], cfg["cluster_size"]
    planes = generate.alignment(cfg, seed)
    root = generate.random_planes(1, L, 0.0, seed)
    founders, private = generate.clock_substitutions(
        root, L, n=n, cluster_size=cs, clock_rate=cfg["clock_rate"], seed=seed,
        rng=np.random.default_rng(seed + 1))
    code = generate.planes_to_nibbles(planes, L)
    root_code = generate.planes_to_nibbles(root, L)[0]
    assert not (root_code == 15).any()
    # the partial columns: M (3) or R (5) in every sample, which neither the
    # root nor a substitution writes
    partial = np.isin(code, (3, 5))
    assert (partial.all(axis=0) == partial.any(axis=0)).all()
    assert partial[0].sum() == cfg["partial_columns"]
    # N is each sample's own: its share is n_share's step (36/256) to 5
    # standard errors in every sample, and no two samples share their sites
    is_n = code == 15
    share, sd = 36 / 256, np.sqrt(36 / 256 * (1 - 36 / 256) / L)
    assert (np.abs(is_n.sum(axis=1) / (L - cfg["partial_columns"]) - share) < 5 * sd).all()
    assert len({row.tobytes() for row in is_n}) == n
    assert not is_n.all(axis=0).any()
    expected = np.zeros((n, L), dtype=bool)
    for c, site, _base in zip(*founders):
        expected[c * cs: (c + 1) * cs, site] = True
    for i, site, _base in zip(*private):
        assert not expected[i, site], "a sample's own site repeats or is its founder's"
        expected[i, site] = True
    assert np.array_equal(code != root_code, expected | partial | is_n)
    # every member holds its founder's base where it is read, and each base
    # is a change
    one_hot = lambda base: 1 << base
    read = ~(partial | is_n)
    for c, site, base in zip(*founders):
        members = slice(c * cs, (c + 1) * cs)
        assert (code[members, site][read[members, site]] == one_hot(base)).all()
    for i, site, base in zip(*private):
        assert not read[i, site] or code[i, site] == one_hot(base)
    assert len(founders[0]) and len(private[0])


def _distances(planes, L) -> np.ndarray:
    """SNP distances of single-base alignments (no N, no partial code)."""
    n, _, W = planes.shape
    bits = np.unpackbits(planes.view(np.uint8), axis=-1, bitorder="little")
    one_hot = bits.reshape(n, 4, W * 32)[:, :, :L].reshape(n, -1).astype(np.float32)
    return L - np.rint(one_hot @ one_hot.T).astype(np.int64)


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_clock_distances_follow_the_clock(seed):
    """Within a cluster two samples lie their two times since the founder
    apart, across clusters their two times since the root, at clock_rate
    substitutions a year.  Each mean over pairs is held to 4 standard
    errors of its Poisson counts (worked out from the pairs each count
    enters), plus what two sets of substitutions meeting at a site take
    off: a set of sizes a and b meet at a * b / L sites on average, each
    taking at most 2 off the distance."""
    n, L, cs, rate = 1000, 8000, 5, 29.903
    planes = generate.alignment(_clock(samples=n, sites=L, cluster_size=cs, clock_rate=rate,
                                       partial_columns=0, n_share=0.0), seed)
    d = _distances(planes, L)
    base, offset = generate.day_parts(n, cs, seed)
    cluster = np.arange(n) // cs
    assert np.array_equal(base[cluster] + offset, generate.sample_days(n, cs, seed))
    lam_founder = rate * base / generate.DAYS_A_YEAR
    lam_own = rate * offset / generate.DAYS_A_YEAR
    i, j = np.triu_indices(n, 1)
    for within in (True, False):
        sel = (cluster[i] == cluster[j]) == within
        pi, pj = i[sel], j[sel]
        lam_i, lam_j = lam_own[pi], lam_own[pj]
        if not within:
            lam_i, lam_j = lam_i + lam_founder[cluster[pi]], lam_j + lam_founder[cluster[pj]]
        expected = (lam_i + lam_j).mean()
        # the mean is a weighted sum of independent Poisson counts
        weight_own = np.bincount(np.concatenate([pi, pj]), minlength=n) / sel.sum()
        var = (weight_own ** 2 * lam_own).sum()
        if not within:
            weight_founder = np.bincount(cluster[np.concatenate([pi, pj])],
                                         minlength=len(base)) / sel.sum()
            var += (weight_founder ** 2 * lam_founder).sum()
        meet = 2 * (lam_i * lam_j).mean() / L
        gap = d[pi, pj].mean() - expected
        assert -4 * np.sqrt(var) - meet <= gap <= 4 * np.sqrt(var), (within, gap, var, meet)


def test_a_clock_configuration_takes_no_max_mutations():
    with pytest.raises(ValueError, match="max_mutations"):
        generate.alignment(_clock(max_mutations=90), 1)
    assert generate.alignment(_clock(max_mutations=None), 1).shape == (60, 4, 94)


def test_an_unknown_structure_raises():
    with pytest.raises(ValueError, match="one of clusters, clock, mixtures$"):
        generate.alignment(_clock(structure="tree"), 1)


def test_a_mixtures_alignment_is_made_from_its_seed():
    a, b = generate.alignment(mixtures(), 11), generate.alignment(mixtures(), 11)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, generate.alignment(mixtures(), 12))
    assert a.shape == (120, 4, 188)


@pytest.mark.parametrize("strains", [2, 3])
@pytest.mark.parametrize("seed", [4, 2**31 + 11])
def test_a_mixtures_code_is_the_or_of_its_strains_bases(seed, strains):
    """Away from each sample's own N and the M/R columns every code is the
    OR of its strains' bases; the sample's own N reads N, and the M/R
    columns read M or R in every sample."""
    cfg = mixtures(strains=strains)
    code = generate.planes_to_nibbles(generate.alignment(cfg, seed), cfg["sites"])
    want = rebuilt_mixtures(cfg, seed)
    read = ~want.is_n & ~want.partial[None]
    assert np.array_equal(code[read], want.mixed[read])
    assert (code[want.is_n & ~want.partial[None]] == 15).all()
    assert np.isin(code[:, want.partial], (3, 5)).all()
    assert want.partial.sum() == cfg["partial_columns"]
    # N is each sample's own, at n_share's step (13/256) to 5 standard errors
    share, sd = 13 / 256, np.sqrt(13 / 256 * (1 - 13 / 256) / cfg["sites"])
    assert (np.abs(want.is_n.mean(axis=1) - share) < 5 * sd).all()
    assert len({row.tobytes() for row in want.is_n}) == cfg["samples"]


@pytest.mark.parametrize("share", [0.15, 0.3, 0.5])
def test_mixed_samples_make_up_mixed_share(share):
    """The mixed samples are round(mixed_share x n), each with its donors
    in other clusters, and they alone hold a 2-bit code outside the M/R
    columns."""
    cfg, seed = mixtures(mixed_share=share), 2**31 + 21
    n, cs = cfg["samples"], cfg["cluster_size"]
    code = generate.planes_to_nibbles(generate.alignment(cfg, seed), cfg["sites"])
    draws = rebuilt_mixtures(cfg, seed).draws
    assert len(draws.mixed) == round(share * n) == len(set(draws.mixed.tolist()))
    assert (draws.donors // cs != draws.mixed[:, None] // cs).all()
    assert ((0 <= draws.donors) & (draws.donors < n)).all()
    bits = np.unpackbits(code[:, :, None], axis=-1).sum(axis=-1)
    partial_columns = np.isin(code, (3, 5)).all(axis=0)
    multi = (bits >= 2) & (code != 15) & ~partial_columns[None]
    assert np.array_equal(np.nonzero(multi.any(axis=1))[0], draws.mixed)


@pytest.mark.parametrize("seed", [6, 2**31 + 13])
def test_segregating_sites_hold_the_root_or_the_alternative(seed):
    """Each founder holds the root's base or the drawn alternative at every
    segregating site, the alternative at minor_allele_share of them, and
    the root's base elsewhere; so a strain differs from its founder only at
    its own substitutions."""
    cfg = mixtures(samples=700, partial_columns=0)
    n, L, cs = cfg["samples"], cfg["sites"], cfg["cluster_size"]
    code = generate.planes_to_nibbles(generate.alignment(cfg, seed), L)
    want = rebuilt_mixtures(cfg, seed)
    draws = want.draws
    seg, alt = draws.seg_site, np.uint8(1) << draws.seg_base
    assert len(seg) == round(0.1 * L) == len(np.unique(seg))
    assert not (alt == want.root[seg]).any()
    # the unmixed samples' strains, read where no N and no own substitution lies
    own = np.zeros((n, L), dtype=bool)
    own[draws.own[0], draws.own[1]] = True
    unmixed = np.setdiff1d(np.arange(n), draws.mixed)
    read = ~want.is_n[unmixed] & ~own[unmixed]
    held = (code[unmixed][:, seg] == alt) & read[:, seg]
    assert ((code[unmixed][:, seg] == want.root[seg]) | held | ~read[:, seg]).all()
    rest = np.ones(L, dtype=bool)
    rest[seg] = False
    assert (code[unmixed][:, rest] == want.root[rest])[read[:, rest]].all()
    # a member holds its founder's allele where it is read
    founder_alt = draws.alleles[unmixed // cs]
    assert (held == founder_alt & read[:, seg]).all()
    # the minor allele's share over the founders, to 5 standard errors
    q, m = 0.2, draws.alleles.size
    assert abs(draws.alleles.mean() - q) < 5 * np.sqrt(q * (1 - q) / m)


@pytest.mark.parametrize("strains,most", [(2, 2), (3, 3)])
def test_three_strains_give_three_bit_codes(strains, most):
    cfg = mixtures(strains=strains, samples=200)
    code = generate.planes_to_nibbles(generate.alignment(cfg, 2**31 + 17), cfg["sites"])
    bits = np.unpackbits(code[:, :, None], axis=-1).sum(axis=-1)
    assert bits[code != 15].max() == most


@pytest.mark.parametrize("key", generate.MIXTURE_KEYS)
def test_a_mixtures_configuration_missing_a_key_raises(key):
    cfg = mixtures()
    del cfg[key]
    with pytest.raises(ValueError, match=f"needs {key}$"):
        generate.alignment(cfg, 1)


def test_a_mixture_carries_two_strains_or_more():
    with pytest.raises(ValueError, match="2 or more"):
        generate.alignment(mixtures(strains=1), 1)
