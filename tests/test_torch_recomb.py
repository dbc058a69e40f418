"""The port's recombination filter (tracs_tpu_torch/ops/recomb.py, the
mismatch-position step of ops/kernels.py and ops/pairsnp.py, and ``distance
--filter``) against tracs_tpu on the CPU.  The same numpy-seeded inputs go
through both packages.  Tolerance 0 on every integer and on the CSV bytes
without --meta; with --meta the transmission distance and expected K come
from two float64 engines and are compared at rtol 1e-9.  The CUDA kernel is
held against its plain version where a card exists."""

import os

import numpy as np
import pytest
import torch

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops import recomb as precomb
from tracs_tpu_torch.ops.packing import compact_variant_columns, from_reference
from tracs_tpu_torch.runtime import native as pnative
from tracs_tpu_torch.runtime import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
GOLDEN_ALN = os.path.join(DATA, "long_filt_style.aln")
FLIP = {"A": "C", "C": "G", "G": "T", "T": "A"}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's counterparts: (ops.recomb, ops.pairsnp, ops.packing,
    runtime.native, cli)."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    from tracs_tpu import cli
    from tracs_tpu.ops import packing, pairsnp, recomb
    from tracs_tpu.runtime import native

    return SimpleNamespace(recomb=recomb, pairsnp=pairsnp, packing=packing,
                           native=native, cli=cli)


def _positions_to_words(positions, length):
    bits = np.zeros((((length + 31) // 32) * 32,), dtype=np.uint8)
    bits[np.asarray(positions, dtype=int)] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32)[None, :]


def _segments(rng, n_pairs, length, dmax=120):
    """Sorted position vectors mixing sparse pairs and pairs with a dense
    cluster of more SNPs than the keep table's count cap."""
    segs = []
    for i in range(n_pairs):
        d = int(rng.integers(2, dmax))
        pos = np.sort(rng.choice(length, size=d, replace=False))
        if i % 4 == 0 and d > 40:
            base = int(rng.integers(0, length - 600))
            pos[: d // 2] = rng.choice(500, size=d // 2, replace=False) + base
            pos = np.unique(pos)
        segs.append(pos.astype(np.int64))
    return segs


def _flat(segs):
    pair_idx = np.repeat(np.arange(len(segs)), [len(s) for s in segs])
    d = np.array([len(s) for s in segs], dtype=np.int64)
    return pair_idx, np.concatenate(segs), d


def _mutated_seqs(rng, n, L, patch=25):
    """Samples off one base: scattered substitutions, and on every second
    sample a dense patch too, so the windowed test has work to do."""
    base = rng.choice(list("ACGT"), size=L)
    seqs = []
    for k in range(n):
        s = base.copy()
        where = rng.choice(L, size=int(rng.integers(2, 60)), replace=False)
        if k % 2:
            start = int(rng.integers(0, L - 60))
            where = np.concatenate([where, np.arange(start, start + patch)])
        for x in where:
            s[x] = FLIP[s[x]]
        seqs.append("".join(s))
    return seqs


def _both(jx, seqs, names=None):
    j = jx.packing.pack_sequences(seqs, names)
    return j, from_reference(j.planes, j.length, j.names)


# -- ops/recomb.py, function by function --

def test_mismatch_positions_matches_reference(jx):
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, size=40, dtype=np.uint32) & rng.integers(
        0, 2**32, size=40, dtype=np.uint32)
    assert np.array_equal(precomb.mismatch_positions(words),
                          jx.recomb.mismatch_positions(words))


@pytest.mark.parametrize("case", ["empty", "one", "clustered", "random"])
def test_filter_recomb_single_matches_reference(jx, case):
    rng = np.random.default_rng(2)
    cases = {
        "empty": [(np.array([], dtype=int), 1000)],
        "one": [(np.array([7]), 1000)],
        "clustered": [(np.array([100, 110, 120, 130, 140, 50_000, 120_000, 190_000]),
                       200_000)],
        "random": [(np.sort(rng.choice(L, size=d, replace=False)), L)
                   for L, d in zip(rng.integers(500, 50_000, size=20),
                                   rng.integers(2, 60, size=20))],
    }[case]
    for pos, L in cases:
        assert precomb.filter_recomb_single(pos, int(L)) == \
            jx.recomb.filter_recomb_single(pos, int(L))
    if case == "clustered":
        assert precomb.filter_recomb_single(*cases[0]) == 3


@pytest.mark.parametrize("batch", [512, 4])
def test_filter_recomb_batch_matches_reference(jx, batch):
    rng = np.random.default_rng(3)
    length = 10_000
    ds = [int(rng.integers(0, 40)) for _ in range(15)]
    mism = np.concatenate([
        _positions_to_words(np.sort(rng.choice(length, size=d, replace=False)), length)
        for d in ds])
    got = precomb.filter_recomb_batch(mism, np.array(ds), length, batch=batch)
    want = jx.recomb.filter_recomb_batch(mism, np.array(ds), length, batch=batch)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    pos_map = np.arange(mism.shape[1] * 32, dtype=np.int64) * 3 + 5
    got = precomb.filter_recomb_batch(mism, np.array(ds), 3 * length + 5, position_map=pos_map)
    want = jx.recomb.filter_recomb_batch(mism, np.array(ds), 3 * length + 5,
                                         position_map=pos_map)
    assert np.array_equal(got, want)


def test_window_w_matches_reference(jx):
    d = np.array([2, 3, 10, 99, 100, 101, 5000, 10**6])
    for length in (1000, 29_903, 1_000_000, 5_000_000):
        assert np.array_equal(precomb._window_w(d, length), jx.recomb._window_w(d, length))
    assert precomb._window_w(7, 1000)[()] == jx.recomb._window_w(7, 1000)[()]


@pytest.mark.parametrize("native", [True, False])
def test_window_stats_matches_reference(jx, monkeypatch, native):
    rng = np.random.default_rng(4)
    length = 200_000
    pair_idx, pos, d = _flat(_segments(rng, 60, length))
    bounds = np.searchsorted(pair_idx, np.arange(len(d) + 1), side="left")
    w_t = precomb._window_w(d, length)
    want = jx.recomb._window_stats(pos, bounds, w_t, pair_idx, length)
    if not native:
        monkeypatch.setattr(pnative, "native_window_stats", lambda *a: None)
    got = precomb._window_stats(pos, bounds, w_t, pair_idx, length)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_native_window_entry_points_match_reference(jx):
    """The port's own build of the native library binds tn_window_stats and
    tn_filter_windows as the JAX package's loader does."""
    rng = np.random.default_rng(5)
    length = 200_000
    pair_idx, pos, d = _flat(_segments(rng, 40, length))
    bounds = np.searchsorted(pair_idx, np.arange(len(d) + 1), side="left")
    w_t = precomb._window_w(d, length)
    got, want = pnative.native_window_stats(pos, bounds, w_t), \
        jx.native.native_window_stats(pos, bounds, w_t)
    assert got is not None and want is not None
    assert got[0].dtype == np.int32 and got[1].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    tabs = [precomb._keep_table(int(x), length) for x in d]
    flat = np.concatenate([np.ascontiguousarray(t, dtype=np.uint8).ravel() for t in tabs])
    offs = np.concatenate([[0], np.cumsum([t.size for t in tabs])])[:-1]
    widths = np.array([t.shape[1] for t in tabs], dtype=np.int64)
    args = (pos, bounds, w_t, flat, offs, widths, precomb._SF_TABLE_CAP)
    got, want = pnative.native_filter_windows(*args), jx.native.native_filter_windows(*args)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1].any()  # the dense clusters overflow the table's count cap


def test_keep_table_and_lookup_match_reference(jx):
    rng = np.random.default_rng(6)
    length = 200_000
    for d in (2, 17, 150):
        got, want = precomb._keep_table(d, length), jx.recomb._keep_table(d, length)
        assert got.shape == want.shape and np.array_equal(got, want)
    d_u = np.array([5, 40, 300])
    n = 500
    d_inv = rng.integers(0, 3, size=n)
    count = rng.integers(2, 40, size=n).astype(np.int32)  # both sides of the table cap
    span = rng.integers(40, 100, size=n).astype(np.int64)
    got = precomb._keep_lookup(count, span, d_u, d_inv, length)
    want = jx.recomb._keep_lookup(count, span, d_u, d_inv, length)
    assert got.dtype == bool and np.array_equal(got, want)
    assert (count > precomb._SF_TABLE_CAP).any() and got.any() and not got.all()


def _full_keep_table(d, length):
    """A keep table evaluated over its whole [count, span] grid."""
    from scipy.stats import binom

    w = int(precomb._window_w(d, length)[()])
    spans = np.arange(2 * w + 2, dtype=np.int64)
    cnts = np.arange(2, precomb._SF_TABLE_CAP + 1, dtype=np.int64)
    return binom.sf(cnts[:, None], spans[None, :], d / length) >= 0.05 / d


@pytest.mark.parametrize("length", [4_000, 29_903, 200_000, 1_000_000])
def test_bisected_keep_tables_equal_the_whole_grid(length):
    """Each table built by bisection on span equals, element for element, the
    one binom.sf gives over the whole grid: from w = _WIN_MAX (d <= 100 at
    1 Mb) through the widths between to w = _WIN_MIN (large d)."""
    d = np.unique(np.geomspace(2, length // 2, 24).astype(np.int64))
    precomb._keep_tables.clear()
    tabs = precomb._keep_tables_for(d, length)
    for dv, tab in zip(d.tolist(), tabs):
        want = _full_keep_table(dv, length)
        assert tab.dtype == bool and tab.shape == want.shape, dv
        assert np.array_equal(tab, want), dv
    widths = precomb._window_w(d, length)
    assert (widths == precomb._WIN_MIN).any() and (widths < 2000).any() and (widths > 50).any()
    first = [int(np.argmax(row)) for tab in tabs for row in tab if row.any()]
    cnt = [k for tab in tabs for k, row in enumerate(tab, start=2) if row.any()]
    if length == 1_000_000:
        assert (widths == precomb._WIN_MAX).any()
        assert not tabs[0].any()  # d = 2: no span is ever kept
    if length == 4_000:
        # sf(k, n, p) is 0 for n <= k: the earliest a row can switch is n = k + 1
        assert any(f == k + 1 for f, k in zip(first, cnt))


def test_keep_tables_build_in_one_batch_and_count_what_they_evaluate():
    length = 200_000
    d = [40, 3, 150, 1200, 3]
    builds, evals = "filter.keep_table_builds", "filter.keep_table_sf_evals"
    precomb._keep_tables.clear()
    b0, e0 = profiling.counter(builds), profiling.counter(evals)
    batch = precomb._keep_tables_for(d, length)
    n_evals = profiling.counter(evals) - e0
    assert profiling.counter(builds) - b0 == 4  # one a distinct distance
    steps = np.ceil(np.log2(2 * precomb._window_w(np.unique(d), length) + 3))
    assert 0 < n_evals <= int((precomb._SF_TABLE_CAP - 1) * steps.sum())
    assert batch[1] is batch[4]
    # built again, nothing is built or evaluated
    b1, e1 = profiling.counter(builds), profiling.counter(evals)
    again = precomb._keep_tables_for(d, length)
    assert all(x is y for x, y in zip(again, batch))
    assert (profiling.counter(builds), profiling.counter(evals)) == (b1, e1)
    # one at a time, cold, the same tables
    precomb._keep_tables.clear()
    for dv, tab in zip(d, batch):
        one = precomb._keep_table(dv, length)
        assert one.shape == tab.shape and np.array_equal(one, tab)
    # a batch of known and new distances builds only the new ones
    b2 = profiling.counter(builds)
    precomb._keep_tables_for([3, 40, 41, 7], length)
    assert profiling.counter(builds) - b2 == 2


@pytest.mark.parametrize("native", [True, False])
def test_filter_flat_matches_reference(jx, monkeypatch, native):
    """_filter_flat (and through it _filter_flat_native, overflow branch
    included) against the JAX package's, with and without the native pass."""
    rng = np.random.default_rng(7)
    length = 200_000
    segs = _segments(rng, 200, length)
    pair_idx, pos, d = _flat(segs)
    want = jx.recomb._filter_flat(pair_idx, pos, d, len(segs), length)
    if native:
        bounds = np.searchsorted(pair_idx, np.arange(len(d) + 1), side="left")
        w_t = precomb._window_w(d, length)
        direct = precomb._filter_flat_native(pos, bounds, w_t, d, length)
        assert np.array_equal(direct, want)
    else:
        monkeypatch.setattr(pnative, "native_filter_windows", lambda *a: None)
        monkeypatch.setattr(pnative, "native_window_stats", lambda *a: None)
    got = precomb._filter_flat(pair_idx, pos, d, len(segs), length)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert (got < d).any() and (got <= d).all()


@pytest.mark.parametrize("method", ["split", "popcount"])
def test_filter_pairs_matches_reference(jx, monkeypatch, method):
    """filter_pairs through the device-position route, the host bitset route
    and under variant compaction: each equals the JAX package's."""
    rng = np.random.default_rng(8)
    L = 4000
    j, p = _both(jx, _mutated_seqs(rng, 10, L))
    ii, jj = np.triu_indices(10, k=1)
    D, _ = port.snp_distance_dense(p, device="cpu")
    dvals = D[ii, jj].astype(np.int64)
    want = jx.recomb.filter_pairs(j, j, ii, jj, dvals, L)
    got = precomb.filter_pairs(p, p, ii, jj, dvals, L, device="cpu", method=method)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert (got[dvals > 20] < dvals[dvals > 20]).any()

    pk, _, pos_map, _ = compact_variant_columns(p)
    got_c = precomb.filter_pairs(pk, pk, ii, jj, dvals, L, device="cpu", method=method,
                                 position_map=pos_map)
    assert np.array_equal(got_c, want)

    monkeypatch.setattr(precomb, "_DEVICE_FILTER_CAP", 0)  # the host bitset route
    host = precomb.filter_pairs(p, p, ii, jj, dvals, L, device="cpu", method=method, chunk=7)
    assert np.array_equal(host, want)


def test_filter_pairs_checks_counts_against_distances(jx):
    rng = np.random.default_rng(9)
    _, p = _both(jx, _mutated_seqs(rng, 4, 2000))
    ii, jj = np.triu_indices(4, k=1)
    D, _ = port.snp_distance_dense(p, device="cpu")
    wrong = D[ii, jj].astype(np.int64) + 1
    with pytest.raises(AssertionError):
        precomb.filter_pairs(p, p, ii, jj, wrong, 2000, device="cpu")


def test_device_filter_cap_is_a_constant():
    """The port reads no environment variable."""
    assert precomb._DEVICE_FILTER_CAP == 8192
    with open(precomb.__file__) as fh:
        assert "environ" not in fh.read()


# -- the mismatch-position step --

@pytest.mark.parametrize("method", ["split", "popcount"])
@pytest.mark.parametrize("db", [False, True])
def test_mismatch_positions_device_matches_reference(jx, method, db):
    rng = np.random.default_rng(10 + db)
    alphabet = np.array(list("ACGTMRWSYKVHDBN-"))
    L = 333  # not a multiple of 32
    ja, pa = _both(jx, ["".join(rng.choice(alphabet, size=L)) for _ in range(7)])
    jb, pb = _both(jx, ["".join(rng.choice(alphabet, size=L)) for _ in range(5)]) \
        if db else (ja, pa)
    ii = rng.integers(0, 7, size=23)
    jj = rng.integers(0, jb.n_seqs, size=23)
    cap = 512
    c0, p0 = jx.pairsnp.mismatch_positions_device(ja, jb, ii, jj, cap)
    c1, p1 = port.mismatch_positions_device(pa, pb, ii, jj, cap, device="cpu", method=method)
    assert c1.dtype == p1.dtype == np.int64 and p1.shape == (23, cap)
    assert np.array_equal(c1, c0)
    valid = np.arange(cap)[None, :] < c0[:, None]
    assert np.array_equal(p1[valid], p0[valid]) and (p1[~valid] == -1).all()
    assert c0.max() > 32 and p1[valid].max() < L


@pytest.mark.parametrize("W", [1, 3, 4, 5, 17])
def test_mismatch_positions_on_padded_layout_match_reference(jx, W):
    """The split layout's pitch is padded with zero words, where no N is set
    and nothing is shared: the kernel's length mask keeps those sites out, so
    counts and positions equal tracs_tpu's, and the plain version on a
    hand-padded layout equals the unpadded one."""
    rng = np.random.default_rng(60 + W)
    alphabet = np.array(list("ACGTMRWSYKVHDBN-"))
    L = 32 * W - 3
    ja, pa = _both(jx, ["".join(rng.choice(alphabet, size=L)) for _ in range(6)])
    ii, jj = rng.integers(0, 6, size=17), rng.integers(0, 6, size=17)
    cap = 32 * W
    c0, p0 = jx.pairsnp.mismatch_positions_device(ja, ja, ii, jj, cap)
    c1, p1 = port.mismatch_positions_device(pa, pa, ii, jj, cap, device="cpu", method="split")
    ea, nm, _ = port._split_device(port._split_pair(pa, None)[0], torch.device("cpu"))
    assert ea.shape[2] == kernels.padded_words(W) and ea.shape[2] * 32 >= L
    valid = np.arange(cap)[None, :] < c0[:, None]
    assert np.array_equal(c1, c0) and np.array_equal(p1[valid], p0[valid])
    assert (p1[~valid] == -1).all() and (p1 < L).all()

    e, m = _word_tensors(rng, 6, W)
    want = kernels.mismatch_positions_reference(e, None, ii, jj, L, cap, m, None)
    pe, pm = kernels.pad_layout(e, m)
    got = kernels.mismatch_positions_kernel(pe, None, ii, jj, L, cap, pm, None)
    assert torch.equal(got, want)


def test_mismatch_positions_device_chunks_its_table(jx, monkeypatch):
    rng = np.random.default_rng(12)
    _, p = _both(jx, _mutated_seqs(rng, 6, 900))
    ii, jj = np.triu_indices(6, k=1)
    want = port.mismatch_positions_device(p, p, ii, jj, 128, device="cpu")
    monkeypatch.setattr(port, "_MISM_TABLE_BYTES", 4 * 129 * 4)  # 4 pairs a launch
    got = port.mismatch_positions_device(p, p, ii, jj, 128, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_mismatch_words_matches_reference(jx):
    rng = np.random.default_rng(13)
    alphabet = np.array(list("ACGTRYN-"))
    ja, pa = _both(jx, ["".join(rng.choice(alphabet, size=205)) for _ in range(6)])
    jb, pb = _both(jx, ["".join(rng.choice(alphabet, size=205)) for _ in range(4)])
    ii, jj = rng.integers(0, 6, size=9), rng.integers(0, 4, size=9)
    got = port.mismatch_words(pa, pb, ii, jj)
    want = jx.pairsnp.mismatch_words(ja, jb, ii, jj)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


def _word_tensors(rng, n, W):
    def w(*shape):
        return torch.from_numpy(rng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32))
    e = w(n, 4, W) & w(n, 4, W) & w(n, 4, W)   # sparse bits: most sites mismatch
    return e, w(n, W) & w(n, W) & w(n, W)


def _naive_positions(pa, pb, ii, jj, length, capacity, ma=None, mb=None):
    """Site-by-site numpy version of the mismatch-position table."""
    A, B = pa.numpy().view(np.uint32), pb.numpy().view(np.uint32)
    out = np.full((len(ii), 1 + capacity), -1, dtype=np.int32)
    for k, (i, j) in enumerate(zip(ii, jj)):
        shared = np.bitwise_or.reduce(A[i] & B[j], axis=0)
        if ma is not None:
            shared |= ma.numpy().view(np.uint32)[i] | mb.numpy().view(np.uint32)[j]
        bits = np.unpackbits((~shared).view(np.uint8), bitorder="little")[:length]
        pos = np.nonzero(bits)[0]
        out[k, 0] = len(pos)
        out[k, 1:1 + min(capacity, len(pos))] = pos[:capacity]
    return out


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("length,capacity", [(32 * 9, 400), (32 * 9 - 13, 400),
                                             (32 * 9 - 13, 16), (0, 8), (77, 0)])
def test_mismatch_positions_reference_exact(masks, length, capacity):
    """The plain version against a site-by-site loop: ragged lengths, a
    capacity below the counts, raw planes and the split layout."""
    rng = np.random.default_rng(14)
    pa, ma = _word_tensors(rng, 6, 9)
    pb, mb = _word_tensors(rng, 5, 9)
    ii, jj = rng.integers(0, 6, size=11), rng.integers(0, 5, size=11)
    m = (ma, mb) if masks else (None, None)
    got = kernels.mismatch_positions_kernel(pa, pb, ii, jj, length, capacity, *m)
    want = _naive_positions(pa, pb, ii, jj, length, capacity, *m)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if capacity == 16:
        assert (want[:, 0] > capacity).all()


def _pair_pattern(name, rng, n):
    """Pair lists as the filter and other callers may send them: runs of one
    first sample (the sweep's row-major COO), one run longer than any group
    of pairs a kernel might take together, a single pair, pairs in no order,
    and every sample against itself."""
    if name == "runs":
        return np.repeat(np.arange(n // 2), 5), np.tile(np.arange(n // 2, n // 2 + 5), n // 2)
    if name == "long run":
        return np.full(300, 2), rng.integers(0, n, size=300)
    if name == "one":
        return np.array([3]), np.array([n - 1])
    if name == "unsorted":
        return rng.integers(0, n, size=333), rng.integers(0, n, size=333)
    assert name == "self"
    return np.arange(n), np.arange(n)


PAIR_PATTERNS = ["runs", "long run", "one", "unsorted", "self"]


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("pattern", PAIR_PATTERNS)
def test_mismatch_positions_pair_patterns_exact(pattern, masks):
    """Whatever the order and the repeats of the pair list, every row of the
    table is its own pair's, in the caller's order."""
    rng = np.random.default_rng(17)
    pa, ma = _word_tensors(rng, 12, 5)
    ii, jj = _pair_pattern(pattern, rng, 12)
    m = (ma, None) if masks else (None, None)
    got = kernels.mismatch_positions_kernel(pa, None, ii, jj, 32 * 5 - 3, 24, *m)
    want = _naive_positions(pa, pa, ii, jj, 32 * 5 - 3, 24, *((ma, ma) if masks else ()))
    assert np.array_equal(got.numpy(), want)


def test_mismatch_positions_layouts_agree():
    """The split layout with its masks gives what the raw planes give."""
    from tracs_tpu_torch.ops.packing import pack_sequences, split_alignment

    rng = np.random.default_rng(15)
    seqs = ["".join(rng.choice(np.array(list("ACGTMRWSYKVHDBN-")), size=500)) for _ in range(8)]
    p = pack_sequences(seqs)
    sa = split_alignment(p)
    ii, jj = np.triu_indices(8, k=1)
    raw = kernels.mismatch_positions_kernel(kernels._as_words(p.planes), None, ii, jj, 500, 512)
    ea, nm, _ = port._split_device(sa, torch.device("cpu"))
    split = kernels.mismatch_positions_kernel(ea, None, ii, jj, 500, 512, nm)
    assert torch.equal(raw, split) and int(raw[:, 0].min()) > 0


def test_mismatch_positions_cpu_call_counts_no_launch():
    rng = np.random.default_rng(16)
    pa, _ = _word_tensors(rng, 3, 2)
    before = profiling.counter("kernel.launches.mism_positions")
    kernels.mismatch_positions_kernel(pa, None, [0, 1], [1, 2], 60, 8)
    assert profiling.counter("kernel.launches.mism_positions") == before


@pytest.mark.parametrize("case", ["int64", "length", "capacity", "index", "shapes",
                                  "mask_alone", "words"])
def test_mismatch_positions_rejects_bad_inputs(case):
    rng = np.random.default_rng(17)
    pa, ma = _word_tensors(rng, 4, 3)
    pb, mb = _word_tensors(rng, 4, 3)
    kw = dict(pa=pa, pb=pb, ii=[0, 1], jj=[1, 2], length=90, capacity=8, ma=None, mb=None)
    if case == "int64":
        kw["pa"] = pa.long()
    elif case == "length":
        kw["length"] = 97
    elif case == "capacity":
        kw["capacity"] = -1
    elif case == "index":
        kw["jj"] = [1, 4]
    elif case == "shapes":
        kw["jj"] = [1]
    elif case == "mask_alone":
        kw["ma"] = ma
    elif case == "words":
        kw["pb"] = _word_tensors(rng, 4, 2)[0]
    with pytest.raises((TypeError, ValueError)):
        kernels.mismatch_positions_kernel(**kw)


# -- pairsnp_stream(filter=True) and pairsnp --

def _assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1] and list(g[2]) == list(w[2])
        for k in range(3, 8):
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
            assert np.asarray(g[k]).dtype == np.int64


@pytest.mark.parametrize("method", ["split", "popcount"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("dist,row_block", [(2**31 - 1, 4), (95, 5)])
def test_stream_filter_matches_reference(jx, method, compact, dist, row_block):
    rng = np.random.default_rng(20)
    j, p = _both(jx, _mutated_seqs(rng, 11, 3000))
    want = list(jx.pairsnp.pairsnp_stream([j], dist=dist, filter=True, row_block=row_block,
                                          compact=compact))
    got = list(port.pairsnp_stream([p], dist=dist, filter=True, row_block=row_block,
                                   compact=compact, method=method, device="cpu"))
    _assert_streams_equal(got, want)
    filt = np.concatenate([g[6] for g in got])
    d = np.concatenate([g[5] for g in got])
    assert (filt <= d).all() and (filt < d).any()


@pytest.mark.parametrize("method", ["split", "popcount"])
@pytest.mark.parametrize("compact", [True, False])
def test_stream_filter_query_vs_db_matches_reference(jx, method, compact):
    rng = np.random.default_rng(21)
    seqs = _mutated_seqs(rng, 12, 2500)
    jq, pq = _both(jx, seqs[:7], [f"q{k}" for k in range(7)])
    jd, pd = _both(jx, seqs[7:], [f"d{k}" for k in range(5)])
    want = jx.pairsnp.pairsnp_stream([jq, jd], dist=400, filter=True, row_block=3,
                                     compact=compact)
    got = port.pairsnp_stream([pq, pd], dist=400, filter=True, row_block=3, compact=compact,
                              method=method, device="cpu")
    _assert_streams_equal(got, want)


def test_stream_filter_iupac_codes_match_reference(jx):
    """Partial IUPAC codes, N and gaps: the split layout's masks decide what
    shares an allele."""
    rng = np.random.default_rng(22)
    alphabet = np.array(list("ACGTMRWSYKVHDBN-acgtnx"))
    j, p = _both(jx, ["".join(rng.choice(alphabet, size=700)) for _ in range(9)])
    want = list(jx.pairsnp.pairsnp_stream([j], filter=True, row_block=4))
    for method in ("split", "popcount"):
        _assert_streams_equal(
            port.pairsnp_stream([p], filter=True, row_block=4, method=method, device="cpu"), want)


@pytest.mark.parametrize("method", ["split", "popcount"])
def test_pairsnp_filter_dense_block(jx, method):
    """The end-to-end case of the JAX package's own filter test: 30 SNPs
    within 300 bp and 4 scattered ones."""
    rng = np.random.default_rng(23)
    L = 20_000
    base = rng.choice(list("ACGT"), size=L)
    s2 = base.copy()
    for x in list(np.arange(5_000, 5_300, 10)) + [1_000, 9_000, 14_000, 19_000]:
        s2[x] = FLIP[s2[x]]
    j, p = _both(jx, ["".join(base), "".join(s2)])
    want = jx.pairsnp.pairsnp([j], dist=10**9, filter=True)
    got = port.pairsnp([p], dist=10**9, filter=True, method=method, device="cpu")
    assert list(got) == list(want)
    assert got[2] == [34] and got[4][0] < 34


@pytest.mark.parametrize("method", ["split", "popcount"])
def test_pairsnp_filter_golden_pattern(method):
    """The reference's published golden: filtered distances [2, 2, 4] on raw
    distances [10, 10, 20]."""
    r, c, d, names, f, nn = port.pairsnp([GOLDEN_ALN], dist=10**6, filter=True,
                                         method=method, device="cpu")
    assert names == ["s0", "s1", "s2"] and list(zip(r, c)) == [(0, 1), (0, 2), (1, 2)]
    assert list(d) == [10, 10, 20] and list(f) == [2, 2, 4]


def test_filter_false_leaves_filt_zero(jx):
    rng = np.random.default_rng(24)
    _, p = _both(jx, _mutated_seqs(rng, 5, 1000))
    for blk in port.pairsnp_stream([p], device="cpu"):
        assert not blk[6].any() and len(blk[6]) == len(blk[3])


# -- distance --filter through the CLI --

def _write_fasta(path, seqs, prefix):
    with open(path, "w") as fh:
        for k, s in enumerate(seqs):
            fh.write(f">{prefix}{k}\n{s}\n")
    return str(path)


def _run_both(jx, tmp_path, args):
    want, got = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jx.cli.main(["distance", *args, "-o", want, "--mesh", "off"])
    port_cli.main(["distance", *args, "-o", got, "--device", "cpu"])
    with open(want, "rb") as a, open(got, "rb") as b:
        return b.read(), a.read()


@pytest.mark.parametrize("extra", [[], ["-D", "60"], ["--row-block", "3"],
                                   ["--row-block", "3", "-D", "60"]])
def test_filter_csv_matches_reference(jx, tmp_path, extra):
    rng = np.random.default_rng(30)
    msa = _write_fasta(tmp_path / "f.fasta", _mutated_seqs(rng, 10, 3000), "s")
    got, want = _run_both(jx, tmp_path, ["--msa", msa, "--filter", *extra])
    assert got == want and got.count(b"\n") > 1
    rows = [ln.split(",") for ln in got.decode().splitlines()[1:]]
    assert all(0 <= int(r[6]) <= int(r[3]) for r in rows)
    assert any(int(r[6]) < int(r[3]) for r in rows)


@pytest.mark.parametrize("row_block", [None, "2"])
def test_filter_csv_golden_pattern(jx, tmp_path, row_block):
    args = ["--msa", GOLDEN_ALN, "--filter"] + (["--row-block", row_block] if row_block else [])
    got, want = _run_both(jx, tmp_path, args)
    assert got == want
    rows = [ln.split(",") for ln in got.decode().splitlines()[1:]]
    assert [r[3] for r in rows] == ["10", "10", "20"] and [r[6] for r in rows] == ["2", "2", "4"]


@pytest.mark.parametrize("row_block", [None, "2"])
def test_filter_msa_db_csv_matches_reference(jx, tmp_path, row_block):
    rng = np.random.default_rng(31)
    seqs = _mutated_seqs(rng, 12, 2000)
    q = _write_fasta(tmp_path / "q.fasta", seqs[:7], "q")
    db = _write_fasta(tmp_path / "db.fasta", seqs[7:], "d")
    args = ["--msa", q, "--msa-db", db, "--filter", "-D", "150"]
    if row_block:
        args += ["--row-block", row_block]
    got, want = _run_both(jx, tmp_path, args)
    assert got == want and got.count(b"\n") > 1


def _write_dates(path, names, rng):
    from datetime import date, timedelta

    with open(path, "w") as fh:
        fh.write("name,date\n")
        for name in names:
            day = date(2019, 1, 1) + timedelta(days=int(rng.integers(0, 400)))
            fh.write(f"{name},{day.isoformat()}\n")
    return str(path)


@pytest.mark.parametrize("extra", [[], ["-K", "60"], ["--row-block", "3"],
                                   ["--row-block", "3", "-K", "60"]])
def test_filter_meta_csv_matches_reference(jx, tmp_path, extra):
    """With --filter and --meta the filtered distance is the model's input
    and fills its column: every column exact but the transmission distance
    and expected K (rtol 1e-9, two float64 engines)."""
    rng = np.random.default_rng(32)
    msa = _write_fasta(tmp_path / "m.fasta", _mutated_seqs(rng, 10, 3000), "s")
    dates = _write_dates(tmp_path / "dates.csv", [f"s{k}" for k in range(10)], rng)
    got, want = _run_both(jx, tmp_path, ["--msa", msa, "--filter", "--meta", dates, "-D", "90",
                                         *extra])
    got, want = got.decode().splitlines(), want.decode().splitlines()
    assert got[0] == want[0] and len(got) == len(want) > 1
    if "-K" in extra:
        plain, _ = _run_both(jx, tmp_path, ["--msa", msa, "--filter", "--meta", dates,
                                            "-D", "90", *extra[:-2]])
        assert len(got) < plain.count(b"\n")
    exact = (0, 1, 2, 3, 6, 7, 8)
    for g, w in zip(got[1:], want[1:]):
        g, w = g.split(","), w.split(",")
        assert [g[k] for k in exact] == [w[k] for k in exact]
        assert g[6] != "NA" and int(g[6]) <= int(g[3])
        np.testing.assert_allclose([float(g[4]), float(g[5])], [float(w[4]), float(w[5])],
                                   rtol=1e-9)


@pytest.mark.parametrize("row_block", [[], ["--row-block", "4"]])
@pytest.mark.parametrize("meta", [False, True])
def test_filter_python_writer_matches_native(tmp_path, monkeypatch, row_block, meta):
    """Without the native library the Python CSV writer gives the same bytes
    for the filtered column."""
    import tracs_tpu_torch.stages.distance as d

    rng = np.random.default_rng(33)
    msa = _write_fasta(tmp_path / "w.fasta", _mutated_seqs(rng, 8, 1500), "s")
    args = ["distance", "--msa", msa, "--filter", "--device", "cpu", *row_block]
    if meta:
        args += ["--meta", _write_dates(tmp_path / "dates.csv", [f"s{k}" for k in range(8)], rng)]
    native = str(tmp_path / "native.csv")
    port_cli.main([*args, "-o", native])
    monkeypatch.setattr(d, "native_format_rows", lambda *a, **k: None)
    plain = str(tmp_path / "plain.csv")
    port_cli.main([*args, "-o", plain])
    with open(native, "rb") as a, open(plain, "rb") as b:
        text = a.read()
        assert text == b.read() and text.count(b"\n") > 1


def test_filter_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["distance", "--msa", GOLDEN_ALN, "--filter", "-o",
                       str(tmp_path / "x.csv")])
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)


# -- on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("n,W,length,capacity,P", [
    (6, 9, 32 * 9 - 13, 400, 11),     # ragged length, capacity above every count
    (6, 9, 32 * 9 - 13, 16, 11),      # capacity below every count
    (40, 1000, 31_990, 64, 300),      # many steps of 32 words, a ragged last step
    (5, 70, 0, 8, 7),                 # no site at all
])
def test_mismatch_positions_cuda_matches_plain(cuda_device, masks, n, W, length, capacity, P):
    rng = np.random.default_rng(n * W + capacity)
    pa, ma = (t.to(cuda_device) for t in _word_tensors(rng, n, W))
    pb, mb = (t.to(cuda_device) for t in _word_tensors(rng, n + 1, W))
    if W == 1000:  # near-identical rows: a few mismatches a pair, most steps skip the scan
        pb = pa[torch.arange(n + 1, device=cuda_device) % n].clone()
        pb[:, 0, ::37] ^= 0x10204
        pa, pb = pa | 0x0F0F0F0F, pb | 0x0F0F0F0F
    ii, jj = rng.integers(0, n, size=P), rng.integers(0, n + 1, size=P)
    m = (ma, mb) if masks else (None, None)
    before = profiling.counter("kernel.launches.mism_positions")
    got = kernels.mismatch_positions_kernel(pa, pb, ii, jj, length, capacity, *m)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.launches.mism_positions") == before + 1
    want = kernels.mismatch_positions_reference(pa, pb, ii, jj, length, capacity, *m)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("pattern", PAIR_PATTERNS)
@pytest.mark.parametrize("capacity", [1, 128, 8192])
@pytest.mark.parametrize("W", [1, 3, 4, 5, 17, 31_252])
def test_mismatch_positions_cuda_pair_patterns(cuda_device, W, capacity, pattern, masks):
    """The kernel on the pair patterns above, at word counts around the
    16-byte pitch and at the main path's, with a capacity below, around and
    above the counts.  At the main path's width the rows are near-identical,
    as within a cluster, and a few pairs stand in for the patterns."""
    rng = np.random.default_rng(W + capacity)
    n = 12
    pa, ma = (t.to(cuda_device) for t in _word_tensors(rng, n, W))
    if W > 1000:
        if pattern not in ("runs", "unsorted"):
            pytest.skip("the main path's width runs two patterns")
        pa = pa[:1].expand(n, 4, W).clone()
        pa[:, 0, ::997] ^= torch.arange(1, n + 1, device=cuda_device, dtype=torch.int32)[:, None]
        pa |= 0x0F0F0F0F
    ii, jj = _pair_pattern(pattern, rng, n)
    m = (ma, None) if masks else (None, None)
    length = 32 * W - (13 if W > 1 else 7)
    got = kernels.mismatch_positions_kernel(pa, None, ii, jj, length, capacity, *m)
    torch.cuda.synchronize()
    want = kernels.mismatch_positions_reference(pa, None, ii, jj, length, capacity, *m)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["split", "popcount"])
def test_stream_filter_cuda_matches_cpu(cuda_device, method):
    rng = np.random.default_rng(40)
    from tracs_tpu_torch.ops.packing import pack_sequences

    seqs = _mutated_seqs(rng, 11, 3000)
    kw = dict(dist=2**31 - 1, filter=True, row_block=4, method=method)
    want = list(port.pairsnp_stream([pack_sequences(seqs)], device="cpu", **kw))
    before = profiling.counter("kernel.launches.mism_positions")
    got = list(port.pairsnp_stream([pack_sequences(seqs)], device=cuda_device, **kw))
    assert profiling.counter("kernel.launches.mism_positions") > before
    _assert_streams_equal(got, want)
