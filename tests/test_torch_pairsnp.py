"""The port's split path (tracs_tpu_torch/ops/pairsnp.py and packing.py)
against tracs_tpu on the CPU: the same numpy-seeded inputs through both
packages, every yielded array compared exactly (tolerance 0 — all outputs
are integers)."""

import gzip
import os
import sys

import numpy as np
import pytest
import torch

from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops.packing import (
    from_reference,
    pack_fasta,
    pack_sequences,
    split_alignment,
)

jax = pytest.importorskip("jax")

from tracs_tpu.ops import packing as jpacking  # noqa: E402
from tracs_tpu.ops import pairsnp as jref  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
IUPAC = np.array(list("ACGTMRWSYKVHDBN-acgtnx"))
CPU = torch.device("cpu")


def _seqs(rng, n, L, alphabet=IUPAC):
    return ["".join(rng.choice(alphabet, size=L)) for _ in range(n)]


def _both(seqs, names=None):
    """(jax PackedAlignment, port PackedAlignment) of the same sequences,
    the port's built from the JAX package's state."""
    j = jpacking.pack_sequences(seqs, names)
    return j, from_reference(j.planes, j.length, j.names)


def _mostly_conserved(rng, n, L, n_var, alphabet="ACGTNRYX-"):
    base = rng.choice(np.array(list("ACGT")), size=L)
    var_cols = rng.choice(L, size=n_var, replace=False)
    seqs = []
    for _ in range(n):
        s = base.copy()
        hit = rng.random(n_var) < 0.5
        s[var_cols[hit]] = rng.choice(np.array(list(alphabet)), size=int(hit.sum()))
        seqs.append("".join(s))
    return seqs


def _assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1] and list(g[2]) == list(w[2])
        for k in range(3, 8):
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
            assert np.asarray(g[k]).dtype == np.int64


def test_port_packer_matches_reference():
    rng = np.random.default_rng(1)
    seqs = _seqs(rng, 7, 333)
    j, p = _both(seqs)
    own = pack_sequences(seqs)
    assert np.array_equal(own.planes, j.planes) and own.length == j.length
    assert np.array_equal(p.planes, j.planes) and p.names == j.names


@pytest.mark.parametrize(
    "planes,length,names",
    [((2, 3, 1), 20, ["a", "b"]), ((2, 4, 2), 20, ["a", "b"]), ((2, 4, 1), 20, ["a"])],
)
def test_from_reference_rejects_mismatched_state(planes, length, names):
    with pytest.raises(ValueError):
        from_reference(np.zeros(planes, dtype=np.uint32), length, names)


def test_pack_fasta_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    seqs = _seqs(rng, 6, 101)
    path = str(tmp_path / "x.fasta.gz")
    with gzip.open(path, "wt") as fh:
        for k, s in enumerate(seqs):
            fh.write(f">s{k} description\n{s[:50]}\n{s[50:]}\n")
    got = pack_fasta(path)
    want = jpacking.pack_fasta(path, use_cache=False)
    assert np.array_equal(got.planes, want.planes)
    assert (got.length, got.names) == (want.length, want.names)


def test_split_alignment_matches_reference():
    rng = np.random.default_rng(3)
    j, p = _both(_seqs(rng, 11, 300))
    got, want = split_alignment(p), jpacking.split_alignment(j)
    _assert_layout_words(got, want)
    for f in ("cnt_n", "partial_pos"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.n_partial, got.length) == (want.n_partial, want.length)


def _assert_layout_words(sa, want, device=CPU):
    """The layout's tensors on ``device`` hold tracs_tpu's excl, nmask and
    partial words, then zero words up to the card's pitch, and its N counts."""
    from tracs_tpu_torch.ops import kernels

    ea, nm, pt = port._split_device(sa, device)
    W, Wp = want.excl.shape[2], want.partial.shape[2]
    assert ea.shape[2] == nm.shape[1] == kernels.padded_words(W)
    assert pt.shape[2] == kernels.padded_words(Wp)
    for got, ref, w in ((ea, want.excl, W), (nm, want.nmask, W), (pt, want.partial, Wp)):
        words = got.numpy().view(np.uint32)
        assert np.array_equal(words[..., :w], ref) and not words[..., w:].any()
    assert np.array_equal(port._cnt_device(sa, device).numpy(), want.cnt_n)


#: the split layout's cases: (samples, sites, alphabet, all-N rows, another
#: alignment whose partial sites join this one's as the gather axis)
LAYOUT_CASES = {
    "ragged length": (11, 300, IUPAC, 0, False),
    "one sample": (1, 77, IUPAC, 0, False),
    "no partial sites": (6, 130, np.array(list("ACGTN-")), 0, False),
    "all-N rows": (7, 96, IUPAC, 3, False),
    "every 2- and 3-bit code": (10, 40, np.array(list("MRWSYKVHDB")), 0, False),
    "partial sites given": (9, 250, IUPAC, 1, True),
}


def _layout_case(name):
    """(jax PackedAlignment, port PackedAlignment, partial_sites or None) of
    a LAYOUT_CASES case, from a seed of its own."""
    n, L, alphabet, n_rows, paired = LAYOUT_CASES[name]
    rng = np.random.default_rng(list(LAYOUT_CASES).index(name) + 60)
    seqs = _seqs(rng, n, L, alphabet)
    if name.startswith("every"):  # each code at a column of its own, too
        seqs[0] = "".join(alphabet[k % len(alphabet)] for k in range(L))
    for k in range(n_rows):
        seqs[k * 2] = "N" * L
    j, p = _both(seqs)
    if not paired:
        return j, p, None
    jo, po = _both(_seqs(rng, 4, L, np.array(list("ACGTYK"))))
    return j, p, np.union1d(port.partial_site_positions(p), port.partial_site_positions(po))


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_device_layout_matches_host_layout_and_reference(case):
    """The layout built on a device (``split_alignment``: the kernels' plain
    versions here) against tracs_tpu's host layout, every field exact: excl
    and nmask at the card's pitch with zero pad words, the partial planes at
    theirs, the N counts, the partial positions and their count."""
    j, p, sites = _layout_case(case)
    dev, want = split_alignment(p, sites), jpacking.split_alignment(j, sites)
    assert dev.device == CPU
    assert np.array_equal(dev.cnt_n, want.cnt_n) and dev.cnt_n.dtype == np.int64
    assert np.array_equal(dev.partial_pos, want.partial_pos)
    assert (dev.n_partial, dev.length, dev.n_seqs) == (want.n_partial, want.length, len(p.names))
    if case == "no partial sites":
        assert dev.n_partial == 0 and not want.partial.any() and want.partial.shape[2] == 1
    _assert_layout_words(dev, want)


def _pairs_of(n_a, n_b, rng):
    """Pair lists over an [n_a, n_b] rectangle: every pair, then 50 drawn."""
    ii, jj = np.divmod(np.arange(n_a * n_b), n_b)
    return (np.concatenate([ii, rng.integers(0, n_a, 50)]),
            np.concatenate([jj, rng.integers(0, n_b, 50)]))


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_comparable_sites_pairs_on_one_route_layouts_matches_reference(case):
    """``comparable_sites_pairs`` on layouts built by the one route (their
    planes only on a device) equals tracs_tpu's, for a self pair and a
    query-vs-db pair, in batches that cut the list."""
    j, p, sites = _layout_case(case)
    rng = np.random.default_rng(list(LAYOUT_CASES).index(case) + 90)
    sa, jsa = split_alignment(p, sites), jpacking.split_alignment(j, sites)
    ii, jj = _pairs_of(p.n_seqs, p.n_seqs, rng)
    got = port.comparable_sites_pairs(sa, sa, ii, jj, device="cpu", batch=7)
    want = np.asarray(jref.comparable_sites_pairs(jsa, jsa, ii, jj, batch=7))
    assert got.dtype == np.int64 and np.array_equal(got, want)
    jo, po = _both(_seqs(rng, 5, p.length, np.array(list("ACGTRN"))))
    pos = np.union1d(port.partial_site_positions(p), port.partial_site_positions(po))
    sa, sb = split_alignment(p, pos), split_alignment(po, pos)
    jsa, jsb = jpacking.split_alignment(j, pos), jpacking.split_alignment(jo, pos)
    ii, jj = _pairs_of(p.n_seqs, po.n_seqs, rng)
    got = port.comparable_sites_pairs(sa, sb, ii, jj, device=CPU, batch=11)
    assert np.array_equal(got, np.asarray(jref.comparable_sites_pairs(jsa, jsb, ii, jj)))


def test_comparable_sites_pairs_on_another_device_matches_reference():
    """A layout asked for on another device than its own: the N masks are
    read from the tensors that device builds (the cross-device route), and
    the counts equal tracs_tpu's."""
    j, p, sites = _layout_case("all-N rows")
    sa = split_alignment(p, sites)
    elsewhere = torch.device("cpu", 0)  # a second key: the CPU is this machine's only device
    ii, jj = _pairs_of(p.n_seqs, p.n_seqs, np.random.default_rng(97))
    got = port.comparable_sites_pairs(sa, sa, ii, jj, device=elsewhere)
    assert elsewhere in sa._dev_cache and sa.device == CPU
    jsa = jpacking.split_alignment(j, sites)
    assert np.array_equal(got, np.asarray(jref.comparable_sites_pairs(jsa, jsa, ii, jj)))
    _assert_layout_words(sa, jsa, elsewhere)


def test_gram_partial_matches_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    j, p = _both(_seqs(rng, 9, 900, np.array(list("ACGTMRWSYKVHDBN"))))
    pt = np.asarray(jpacking.split_alignment(j).partial)
    assert pt.shape[2] > 1
    want = np.asarray(jref._gram_partial(jnp.asarray(pt[2:7]), jnp.asarray(pt)))
    got = port.partial_gram(port._as_words(pt[2:7]), port._as_words(pt))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_derive_split_planes_matches_host_layout():
    """The device layout's planes (``split_layout``, here its plain version)
    are tracs_tpu's host layout's words, then zero words up to the card's pitch."""
    from tracs_tpu_torch.ops import kernels

    rng = np.random.default_rng(5)
    j, p = _both(_seqs(rng, 8, 200))
    sa = jpacking.split_alignment(j)
    W = p.planes.shape[2]
    ea, nm = kernels.split_layout(port._as_words(p.planes))[:2]
    assert np.array_equal(ea.numpy().view(np.uint32)[:, :, :W], sa.excl)
    assert np.array_equal(nm.numpy().view(np.uint32)[:, :W], sa.nmask)
    assert not ea[:, :, W:].any() and not nm[:, W:].any()


@pytest.mark.parametrize("W", [1, 3, 4, 5, 17])
def test_split_device_pads_the_word_pitch(W):
    """The resident split layout gets the card's word pitch: the host
    layout's words, then zero words up to a multiple of 4 (the partial planes
    on their own axis too); the blocks computed from it equal tracs_tpu's."""
    from tracs_tpu_torch.ops import kernels

    rng = np.random.default_rng(50 + W)
    L = 32 * W - 9
    j, p = _both(_seqs(rng, 9, L))
    layout = split_alignment(p)
    ea, nm, pt = port._split_device(layout, CPU)
    sa = jpacking.split_alignment(j)
    assert sa.excl.shape[2] == W
    Wp = kernels.padded_words(W)
    assert Wp % 4 == 0 and W <= Wp < W + 4
    assert ea.shape == (9, 4, Wp) and nm.shape == (9, Wp)
    assert ea.is_contiguous() and nm.is_contiguous()
    assert np.array_equal(ea.numpy().view(np.uint32)[:, :, :W], sa.excl)
    assert np.array_equal(nm.numpy().view(np.uint32)[:, :W], sa.nmask)
    assert not ea[:, :, W:].any() and not nm[:, W:].any()
    # the partial planes: their own word axis, padded by the same rule
    Wq = sa.partial.shape[2]
    assert pt.shape == (9, 4, kernels.padded_words(Wq)) and pt.is_contiguous()
    assert np.array_equal(pt.numpy().view(np.uint32)[:, :, :Wq], sa.partial)
    assert not pt[:, :, Wq:].any()
    assert port._split_device(layout, CPU)[0] is ea  # cached, padded once
    D, NN = port.snp_distance_dense(p, device="cpu")
    Dj, NNj = jref.snp_distance_dense(j)
    assert np.array_equal(D, np.asarray(Dj)) and np.array_equal(NN, np.asarray(NNj))


def test_ambig_golden_matches_reference():
    path = os.path.join(DATA, "ambig.aln")
    got = port.pairsnp([path], dist=10, device="cpu")
    want = jref.pairsnp([path], dist=10)
    assert list(got[0]) == [0, 0, 0, 0, 1, 1, 1, 2, 2, 3]
    assert list(got[1]) == [1, 2, 3, 4, 2, 3, 4, 3, 4, 4]
    assert list(got[2]) == [0, 2, 1, 1, 2, 2, 2, 3, 3, 0]
    for g, w in zip(got, want):
        assert list(g) == list(w)


@pytest.mark.parametrize("row_block", [1, 3, 7, 100])
@pytest.mark.parametrize("dist", [0, 150, port.INT32_MAX])
def test_stream_matches_reference(row_block, dist):
    """Random IUPAC with '-' and lowercase, L not a multiple of 32."""
    rng = np.random.default_rng(row_block)
    j, p = _both(_seqs(rng, 19, 333))
    if dist == 0:  # make some identical pairs so dist=0 emits something
        j.planes[5] = j.planes[2]
        p.planes[5] = p.planes[2]
    _assert_streams_equal(
        port.pairsnp_stream([p], dist=dist, row_block=row_block, device="cpu"),
        jref.pairsnp_stream([j], dist=dist, row_block=row_block),
    )


@pytest.mark.parametrize("start_row", [3, 6, 18])
def test_stream_start_row_matches_reference(start_row):
    rng = np.random.default_rng(start_row)
    j, p = _both(_seqs(rng, 19, 200))
    _assert_streams_equal(
        port.pairsnp_stream([p], dist=120, row_block=3, start_row=start_row, device="cpu"),
        jref.pairsnp_stream([j], dist=120, row_block=3, start_row=start_row),
    )


def test_stream_launches_the_next_block_before_it_yields_one(monkeypatch):
    """The one-device sweep launches block r + 1 before it yields block r,
    and what it yields is what it would yield block by block."""
    rng = np.random.default_rng(31)
    j, p = _both(_seqs(rng, 19, 200))
    launched = []
    real = port._launch_block

    def launch(engine, a, b, r0, *rest):
        launched.append(r0)
        return real(engine, a, b, r0, *rest)

    monkeypatch.setattr(port, "_launch_block", launch)
    stream = port.pairsnp_stream([p], dist=120, row_block=3, device="cpu")
    got = []
    for block in stream:
        assert launched == list(range(0, min(19, block[0] + 6), 3))
        got.append(block)
    _assert_streams_equal(got, jref.pairsnp_stream([j], dist=120, row_block=3))


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("row_block", [2, 64])
def test_two_fasta_rectangle_matches_reference(compact, row_block):
    """Query-vs-db with partial codes on both sides, compaction on and off."""
    rng = np.random.default_rng(10 + row_block)
    q = _mostly_conserved(rng, 6, 512, 40, alphabet="ACGTMRWSYKN-")
    d = _mostly_conserved(rng, 5, 512, 40, alphabet="ACGTVHDB")
    d = [q[0][:256] + s[256:] for s in d]  # shared backbone: compaction triggers
    jq, pq = _both(q, [f"q{k}" for k in range(6)])
    jd, pd = _both(d, [f"d{k}" for k in range(5)])
    _assert_streams_equal(
        port.pairsnp_stream([pq, pd], dist=400, row_block=row_block, compact=compact,
                            device="cpu"),
        jref.pairsnp_stream([jq, jd], dist=400, row_block=row_block, compact=compact),
    )


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("dist", [0, 3, 10**9])
def test_compaction_matches_reference(compact, dist):
    rng = np.random.default_rng(1234)
    j, p = _both(_mostly_conserved(rng, 9, 700, 60))
    got = port.pairsnp([p], dist=dist, compact=compact, device="cpu")
    want = jref.pairsnp([j], dist=dist, compact=compact)
    for g, w in zip(got, want):
        assert list(g) == list(w)
    if compact:
        assert port._cached_compact(p, p) is not None  # the repack really ran


@pytest.mark.parametrize("row_block", [4, 4096])
def test_snp_distance_dense_matches_reference(row_block):
    rng = np.random.default_rng(6)
    j, p = _both(_seqs(rng, 13, 257))
    D, NN = port.snp_distance_dense(p, device="cpu", row_block=row_block)
    D0, NN0 = jref.snp_distance_dense(j, method="split")
    assert np.array_equal(D, D0) and np.array_equal(NN, NN0)
    jq, pq = _both(_seqs(rng, 4, 257))
    D, NN = port.snp_distance_dense(pq, p, device="cpu", row_block=row_block)
    D0, NN0 = jref.snp_distance_dense(jq, j, method="split")
    assert np.array_equal(D, D0) and np.array_equal(NN, NN0)


@pytest.mark.parametrize("triangle,r0,c0", [(True, 5, 5), (True, 0, 0), (False, 7, 0)])
def test_extract_coo_order_matches_reference(triangle, r0, c0):
    import jax.numpy as jnp

    rng = np.random.default_rng(r0 + c0)
    D = rng.integers(0, 40, size=(9, 14), dtype=np.int32)
    NN = rng.integers(0, 99, size=(9, 14), dtype=np.int32)
    n_valid = c0 + 12  # the last two columns are dead padding
    packed = np.asarray(jref._extract_coo_packed(
        jnp.asarray(D), jnp.asarray(NN), 20, jnp.int32(r0), jnp.int32(n_valid),
        jnp.int32(c0), capacity=9 * 14, triangle=triangle,
    ))
    want = jref._unpack_survivors(packed, 9 * 14, int(packed[0]), 14, c0)
    # the popcount engine's grams of these blocks: D = L - matches, NN = L - nunion
    L = 1000
    grams = {"mode": "direct", "g": torch.from_numpy(L - D), "gn": torch.from_numpy(L - NN)}
    got = port._extract_coo(grams, L, 20, r0, n_valid, c0, triangle=triangle)
    assert len(got[0]) == int(packed[0]) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_prefix_block_is_column_suffix():
    """A triangle block's columns start at its own first row (c0 = r0)."""
    rng = np.random.default_rng(8)
    _, p = _both(_seqs(rng, 10, 90))
    sa = split_alignment(p)
    D, NN, c0 = port.snp_distance_split_prefix_device(sa, 4, 7, device=CPU)
    Df, NNf = port.snp_distance_split_device(sa, device=CPU)
    assert c0 == 4 and D.shape == (3, 6)
    assert torch.equal(D, Df[4:7, 4:]) and torch.equal(NN, NNf[4:7, 4:])
    with pytest.raises(ValueError):
        port.snp_distance_split_prefix_device(sa, 7, 7, device=CPU)


def test_pair_layouts_must_share_partial_axis():
    rng = np.random.default_rng(9)
    _, a = _both(_seqs(rng, 3, 64))
    _, b = _both(_seqs(rng, 3, 64))
    with pytest.raises(ValueError):
        port.snp_distance_split_device(split_alignment(a), split_alignment(b), device=CPU)


def test_unported_options_raise():
    """method="mxu" is ported (tests/test_torch_mxu.py): it yields what the
    split engine yields, with and without the filter; an unknown method
    raises."""
    rng = np.random.default_rng(10)
    _, p = _both(_seqs(rng, 3, 64))
    for filter_ in (False, True):
        got = list(port.pairsnp_stream([p], filter=filter_, method="mxu", device="cpu"))
        want = list(port.pairsnp_stream([p], filter=filter_, method="split", device="cpu"))
        for g, w in zip(got, want):
            assert all(np.array_equal(x, y) for x, y in zip(g[3:], w[3:]))
    with pytest.raises(ValueError):
        list(port.pairsnp_stream([p], method="bogus", device="cpu"))


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from tracs_tpu_torch.runtime.device import DeviceUnavailableError

    rng = np.random.default_rng(11)
    _, p = _both(_seqs(rng, 3, 64))
    with pytest.raises(DeviceUnavailableError):
        list(port.pairsnp_stream([p], device="cuda"))


def test_smoke_workload_matches_bench():
    """chip_smoke.py's workload generator (the package's
    experiments/workload.py, of which the script keeps no copy) is
    bench.py's make_clustered, array for array."""
    sys.path.insert(0, REPO)
    import bench
    import chip_smoke

    from tracs_tpu_torch.experiments import workload

    assert not hasattr(chip_smoke, "random_planes")
    got = workload.make_clustered(70, 4000, cluster_size=6, n_partial_cols=64)
    want = bench.make_clustered(70, 4000, cluster_size=6, n_partial_cols=64)
    assert np.array_equal(got.planes, want.planes) and got.names == want.names


@pytest.mark.parametrize("cache", ["split pair", "compact"])
def test_layout_caches_hold_the_partner_not_its_id(monkeypatch, cache):
    """A layout cached for one partner is never served to another object,
    even one that presents the same ``id`` (as a new object can, once the
    old partner is freed): the entry holds the partner and is compared with
    ``is``."""
    rng = np.random.default_rng(41)
    seqs = _mostly_conserved(rng, 13, 256, 40)  # one base genome, so compaction drops columns
    a, b1, b2 = (pack_sequences(seqs[lo:hi]) for lo, hi in ((0, 5), (5, 9), (9, 13)))
    monkeypatch.setattr(port, "id", lambda obj: 7, raising=False)  # every object "shares" an id
    fn, attr = ((port._split_pair, "_split_pair_cache") if cache == "split pair"
                else (port._cached_compact, "_compact_res"))
    first = fn(a, b1)
    assert getattr(a, attr)[0] is b1 and fn(a, b1) is first
    second = fn(a, b2)
    assert second is not first and getattr(a, attr)[0] is b2
    fresh = (port.split_alignment if cache == "split pair" else None)
    if cache == "split pair":
        pos = np.union1d(port.partial_site_positions(a), port.partial_site_positions(b2))
        assert torch.equal(port._split_device(second[1], CPU)[0],
                           port._split_device(fresh(b2, pos), CPU)[0])
    else:
        want = port.compact_variant_columns(a, b2)
        assert np.array_equal(second[1].planes, want[1].planes)
