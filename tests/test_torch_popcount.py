"""The port's popcount engine (ops/kernels.py ``popcount_gram`` and
``method="popcount"`` of ops/pairsnp.py) against the JAX package: the Pallas
kernels K2/K3 in interpret mode (``snp_distance_pallas``), their XLA twin
``_gram_popcount`` and ``pairsnp_stream(method="popcount")``, and against
the port's own split engine.  Tolerance 0: every output is an integer.  The
CUDA kernel is held against its plain version where a card exists.

jax is imported inside the tests that need it, so the card-only tests run
on a machine without it."""

import os

import numpy as np
import pytest
import torch

from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops.packing import from_reference, pack_sequences
from tracs_tpu_torch.runtime import profiling

IUPAC = np.array(list("ACGTMRWSYKVHDBN-"))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _seqs(rng, n, L, alphabet=IUPAC):
    return ["".join(rng.choice(alphabet, size=L)) for _ in range(n)]


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


@pytest.fixture
def jax_ref():
    """(tracs_tpu packing, tracs_tpu pairsnp, snp_distance_pallas)."""
    pytest.importorskip("jax")
    from tracs_tpu.ops import packing as jpacking
    from tracs_tpu.ops import pairsnp as jref
    from tracs_tpu.ops.pallas_kernels import snp_distance_pallas

    return jpacking, jref, snp_distance_pallas


def _both(jpacking, seqs, names=None):
    j = jpacking.pack_sequences(seqs, names)
    return j, from_reference(j.planes, j.length, j.names)


def _assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1] and list(g[2]) == list(w[2])
        for k in range(3, 8):
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
            assert np.asarray(g[k]).dtype == np.int64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# -- the kernel's plain version against K2/K3 and _gram_popcount --

@pytest.mark.parametrize("na,nb,L", [(37, 37, 533), (37, 11, 533), (130, 5, 9000)])
def test_popcount_gram_matches_pallas_and_xla(jax_ref, na, nb, L):
    """Full matrices: the wrapper (CPU -> plain version) equals Pallas
    K2/K3 in interpret mode and the XLA twin _gram_popcount, on full IUPAC
    with '-' and N, ragged last word."""
    import jax.numpy as jnp

    jpacking, jref, snp_distance_pallas = jax_ref
    rng = np.random.default_rng(na * 100 + nb)
    ja, a = _both(jpacking, _seqs(rng, na, L))
    jb, b = (ja, a) if nb == na else _both(jpacking, _seqs(rng, nb, L))
    D0, NN0 = snp_distance_pallas(ja, None if nb == na else jb, interpret=True)
    m0, u0 = (np.asarray(x) for x in jref._gram_popcount(jnp.asarray(ja.planes),
                                                           jnp.asarray(jb.planes)))
    pa = kernels._as_words(a.planes)
    pb = None if nb == na else kernels._as_words(b.planes)
    for fn in (kernels.popcount_gram, kernels.popcount_gram_reference):
        matches, nunion = fn(pa, 0, na, 0, pb)
        assert matches.dtype == nunion.dtype == torch.int32
        assert np.array_equal(matches.numpy(), m0) and np.array_equal(nunion.numpy(), u0)
        assert np.array_equal(L - matches.numpy(), D0)
        assert np.array_equal(L - nunion.numpy(), NN0)
    D, NN = kernels.snp_distance_popcount(a, None if nb == na else b, device="cpu")
    assert D.dtype == NN.dtype == np.int32
    assert np.array_equal(D, D0) and np.array_equal(NN, NN0)


@pytest.mark.parametrize(
    "n,nb,L,r0,rb,c0",
    [(37, None, 533, 5, 20, 9), (64, None, 700, 32, 32, 32), (50, None, 300, 49, 1, 0),
     (41, None, 97, 0, 41, 40), (48, 14, 545, 5, 37, 3)],
)
def test_popcount_gram_ranged_matches_xla(jax_ref, n, nb, L, r0, rb, c0):
    """Row-block x column-suffix addressing (r0 > 0, c0 > 0, rectangles)
    equals the matching slice of _gram_popcount's full matrix."""
    import jax.numpy as jnp

    jpacking, jref, _ = jax_ref
    rng = np.random.default_rng(n + L + r0)
    ja, a = _both(jpacking, _seqs(rng, n, L))
    jb, b = (ja, a) if nb is None else _both(jpacking, _seqs(rng, nb, L))
    m0, u0 = (np.asarray(x) for x in jref._gram_popcount(jnp.asarray(ja.planes),
                                                           jnp.asarray(jb.planes)))
    pb = None if nb is None else kernels._as_words(b.planes)
    matches, nunion = kernels.popcount_gram(kernels._as_words(a.planes), r0, rb, c0, pb)
    assert matches.shape == (rb, b.n_seqs - c0)
    assert np.array_equal(matches.numpy(), m0[r0:r0 + rb, c0:])
    assert np.array_equal(nunion.numpy(), u0[r0:r0 + rb, c0:])


def test_popcount_reference_chunking_is_exact(monkeypatch):
    """One-word chunks (the memory bound at its tightest) give the same
    counts as one chunk."""
    rng = np.random.default_rng(7)
    pa = kernels._as_words(pack_sequences(_seqs(rng, 23, 250)).planes)
    want = kernels.popcount_gram_reference(pa, 3, 15, 4)
    monkeypatch.setattr(kernels, "_REFERENCE_BYTES", 1)
    got = kernels.popcount_gram_reference(pa, 3, 15, 4)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_popcount_reference_is_the_bitwise_count():
    """Inclusion-exclusion over the OR equals the direct OR-of-ANDs count
    (numpy popcount) on all-ones, all-N and random words, sign bit
    included."""
    from tracs_tpu_torch.ops.packing import popcount_words

    rng = np.random.default_rng(12)
    w = rng.integers(0, 2**32, size=(9, 4, 5), dtype=np.uint32)
    w[0] = 0xFFFFFFFF
    w[1] = 0
    matches, nunion = kernels.popcount_gram_reference(kernels._as_words(w), 0, 9, 0)
    a, b = w[:, None], w[None, :]
    shared = (a[..., 0, :] & b[..., 0, :]) | (a[..., 1, :] & b[..., 1, :]) \
        | (a[..., 2, :] & b[..., 2, :]) | (a[..., 3, :] & b[..., 3, :])
    n = w[:, 0] & w[:, 1] & w[:, 2] & w[:, 3]
    assert np.array_equal(matches.numpy(), popcount_words(shared).sum(axis=-1))
    assert np.array_equal(nunion.numpy(),
                          popcount_words(n[:, None] | n[None, :]).sum(axis=-1))
    assert int(matches[0, 0]) == int(nunion[0, 0]) == 5 * 32


def test_popcount_cpu_call_counts_no_launch():
    rng = np.random.default_rng(3)
    pa = kernels._as_words(pack_sequences(_seqs(rng, 5, 64)).planes)
    before = profiling.counter("kernel.launches.popcount_gram")
    kernels.popcount_gram(pa, 0, 5, 0)
    assert profiling.counter("kernel.launches.popcount_gram") == before


@pytest.mark.parametrize("case", ["int64", "shape", "noncontig", "rows", "cols", "words", "meta"])
def test_popcount_gram_rejects_bad_inputs(case):
    pa = torch.zeros((6, 4, 3), dtype=torch.int32)
    args = dict(pa=pa, r0=0, rb=6, c0=0, pb=None)
    if case == "int64":
        args["pa"] = pa.long()
    elif case == "shape":
        args["pa"] = torch.zeros((6, 3, 3), dtype=torch.int32)
    elif case == "noncontig":
        args["pa"] = torch.zeros((6, 4, 6), dtype=torch.int32)[:, :, ::2]
    elif case == "rows":
        args["r0"] = 2
    elif case == "cols":
        args["c0"] = 7
    elif case == "words":
        args["pb"] = torch.zeros((2, 4, 4), dtype=torch.int32)
    elif case == "meta":
        args["pa"] = pa.to("meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.popcount_gram(**args)


# -- the card's pitch: raw planes padded with zero words --

PAD_WORDS = [1, 3, 4, 5, 17]


def _random_planes(rng, n, W):
    return kernels._as_words(rng.integers(0, 2**32, size=(n, 4, W), dtype=np.uint32))


@pytest.mark.parametrize("W", PAD_WORDS)
def test_popcount_gram_on_padded_planes_matches_unpadded(W):
    """Zero words up to the card's pitch share no allele and hold no N: they
    add nothing to either count."""
    rng = np.random.default_rng(29 * W)
    pa, pb = _random_planes(rng, 13, W), _random_planes(rng, 9, W)
    want = kernels.popcount_gram(pa, 2, 10, 1, pb)
    qa, qb = kernels.pad_planes(pa), kernels.pad_planes(pb)
    assert qa.shape[2] == qb.shape[2] == kernels.padded_words(W)
    assert (qa is pa) == (W % kernels.LAYOUT_WORD_MULTIPLE == 0)
    got = kernels.popcount_gram(qa, 2, 10, 1, qb)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("W", PAD_WORDS)
def test_popcount_stream_on_padded_planes_matches_unpadded(monkeypatch, W):
    """The resident raw planes carry the card's pitch on every device; the
    sweep yields what it yields on planes at their own pitch."""
    rng = np.random.default_rng(31 * W)
    L = 32 * W - 5
    seqs = _seqs(rng, 11, L)
    kw = dict(dist=L // 2, row_block=4, device="cpu", method="popcount", compact=False)
    p = pack_sequences(seqs)
    got = list(port.pairsnp_stream([p], **kw))
    assert p._dev_planes[1].shape[2] == kernels.padded_words(W)
    monkeypatch.setattr(port, "pad_planes", lambda planes: planes)
    q = pack_sequences(seqs)
    want = list(port.pairsnp_stream([q], **kw))
    assert q._dev_planes[1].shape[2] == W
    assert sum(len(b[3]) for b in want) > 0
    _assert_streams_equal(got, want)


@pytest.mark.parametrize("W", PAD_WORDS)
def test_mismatch_positions_on_padded_raw_planes_match_unpadded(W):
    """Raw planes with null masks: a zero pad word reads as 32 mismatching
    sites, and only the length keeps them out of the table.  Lengths that end
    inside a word (no multiple of 32, none of 128) and at the last word's end."""
    rng = np.random.default_rng(37 * W)
    pa = _random_planes(rng, 7, W)
    qa = kernels.pad_planes(pa)
    ii, jj = [0, 1, 2, 6, 3], [1, 2, 5, 0, 3]
    for L in sorted({32 * W - 5, 32 * W, max(1, 32 * W - 33)}):
        want = kernels.mismatch_positions_kernel(pa, None, ii, jj, L, 40)
        got = kernels.mismatch_positions_kernel(qa, None, ii, jj, L, 40)
        assert torch.equal(got, want), L
        assert int(want[:, 0].max()) > 0 and int(want[:, 1:].max()) < L
    if qa is not pa:  # past the length the pad does show: the mask is what hides it
        more = kernels.mismatch_positions_kernel(qa, None, ii, jj, 32 * qa.shape[2], 40)
        assert torch.all(more[:, 0] >= want[:, 0] + 32 * (qa.shape[2] - W))


@pytest.mark.parametrize("side", ["A", "B"])
def test_popcount_gram_refuses_unpadded_planes_off_the_cpu(side):
    """A CUDA-typed operand at a pitch the kernel's 16-byte copies cannot take
    is refused, with the helper that pads it named; a padded one gets past
    that check (and then fails only for lack of a card)."""
    bad = torch.zeros((6, 4, 5), dtype=torch.int32, device="meta")
    good = torch.zeros((6, 4, 8), dtype=torch.int32, device="meta")
    args = (bad, 0, 6, 0, None) if side == "A" else (good, 0, 6, 0, bad)
    with pytest.raises(ValueError, match=r"pad_planes\(p\)"):
        kernels.popcount_gram(*args)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        kernels.popcount_gram(good, 0, 6, 0)


def test_popcount_gram_word_limit_keeps_int32_exact():
    """8 subsets of one sign, 32 sites a word: the kernel's int32 sums hold
    every count below the wrapper's word limit."""
    assert 8 * 32 * (kernels._POPCOUNT_GRAM_MAX_WORDS - 1) < 2**31


# -- the popcount engine of pairsnp against JAX's and the split engine --

@pytest.mark.parametrize("row_block", [1, 3, 7, 100])
@pytest.mark.parametrize("dist", [0, 150, port.INT32_MAX])
def test_popcount_stream_matches_reference_and_split(jax_ref, row_block, dist):
    jpacking, jref, _ = jax_ref
    rng = np.random.default_rng(row_block)
    j, p = _both(jpacking, _seqs(rng, 19, 333, np.array(list("ACGTMRWSYKVHDBN-acgtnx"))))
    if dist == 0:  # some identical pairs, so dist=0 emits something
        j.planes[5] = j.planes[2]
        p.planes[5] = p.planes[2]
    got = list(port.pairsnp_stream([p], dist=dist, row_block=row_block, device="cpu",
                                   method="popcount"))
    _assert_streams_equal(got, jref.pairsnp_stream([j], dist=dist, row_block=row_block,
                                                   method="popcount"))
    _assert_streams_equal(got, port.pairsnp_stream([p], dist=dist, row_block=row_block,
                                                   device="cpu", method="split"))


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("row_block", [2, 64])
def test_popcount_rectangle_matches_reference_and_split(jax_ref, compact, row_block):
    """Query-vs-db (c0 = 0) with partial codes on both sides, compaction on
    and off."""
    jpacking, jref, _ = jax_ref
    rng = np.random.default_rng(10 + row_block)
    q = _mostly_conserved(rng, 6, 512, 40, alphabet="ACGTMRWSYKN-")
    d = _mostly_conserved(rng, 5, 512, 40, alphabet="ACGTVHDB")
    d = [q[0][:256] + s[256:] for s in d]  # shared backbone: compaction triggers
    jq, pq = _both(jpacking, q, [f"q{k}" for k in range(6)])
    jd, pd = _both(jpacking, d, [f"d{k}" for k in range(5)])
    got = list(port.pairsnp_stream([pq, pd], dist=400, row_block=row_block, compact=compact,
                                   device="cpu", method="popcount"))
    _assert_streams_equal(got, jref.pairsnp_stream([jq, jd], dist=400, row_block=row_block,
                                                   compact=compact, method="popcount"))
    _assert_streams_equal(got, port.pairsnp_stream([pq, pd], dist=400, row_block=row_block,
                                                   compact=compact, device="cpu"))


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("start_row", [0, 6])
def test_popcount_self_compaction_matches_reference_and_split(jax_ref, compact, start_row):
    """The triangle sweep (c0 = r0) on compacted planes with nn_off, and a
    resumed start row."""
    jpacking, jref, _ = jax_ref
    rng = np.random.default_rng(1234)
    j, p = _both(jpacking, _mostly_conserved(rng, 13, 700, 60))
    kw = dict(dist=12, row_block=3, start_row=start_row, compact=compact)
    got = list(port.pairsnp_stream([p], device="cpu", method="popcount", **kw))
    assert sum(len(g[3]) for g in got) > 0
    _assert_streams_equal(got, jref.pairsnp_stream([j], method="popcount", **kw))
    _assert_streams_equal(got, port.pairsnp_stream([p], device="cpu", **kw))
    if compact:
        assert port._cached_compact(p, p) is not None  # the repack really ran


@pytest.mark.parametrize("row_block", [4, 4096])
def test_popcount_dense_matches_reference(jax_ref, row_block):
    jpacking, jref, _ = jax_ref
    rng = np.random.default_rng(6)
    j, p = _both(jpacking, _seqs(rng, 13, 257))
    D, NN = port.snp_distance_dense(p, device="cpu", row_block=row_block, method="popcount")
    D0, NN0 = jref.snp_distance_dense(j, method="popcount")
    assert np.array_equal(D, D0) and np.array_equal(NN, NN0)
    jq, pq = _both(jpacking, _seqs(rng, 4, 257))
    D, NN = port.snp_distance_dense(pq, p, device="cpu", row_block=row_block,
                                    method="popcount")
    D0, NN0 = jref.snp_distance_dense(jq, j, method="popcount")
    assert np.array_equal(D, D0) and np.array_equal(NN, NN0)


def test_popcount_ambig_golden():
    got = port.pairsnp([os.path.join(DATA, "ambig.aln")], dist=10, device="cpu",
                       method="popcount")
    assert list(got[0]) == [0, 0, 0, 0, 1, 1, 1, 2, 2, 3]
    assert list(got[1]) == [1, 2, 3, 4, 2, 3, 4, 3, 4, 4]
    assert list(got[2]) == [0, 2, 1, 1, 2, 2, 2, 3, 3, 0]


def test_popcount_planes_cached_and_split_layout_untouched():
    """The popcount engine uploads the raw planes once per alignment and
    device, and builds no split layout."""
    rng = np.random.default_rng(13)
    p = pack_sequences(_seqs(rng, 9, 100))
    list(port.pairsnp_stream([p], row_block=2, device="cpu", method="popcount",
                             compact=False))
    first = p._dev_planes[1]
    list(port.pairsnp_stream([p], row_block=4, device="cpu", method="popcount",
                             compact=False))
    assert p._dev_planes[1] is first
    assert getattr(p, "_split_cache", None) is None


@pytest.mark.parametrize("method,exc", [("mxu", None), ("bogus", ValueError)])
def test_other_methods_raise(method, exc):
    """An unknown method raises; ``mxu`` is ported and runs."""
    p = pack_sequences(["ACGT", "ACGA"])
    if exc is None:
        assert list(port.pairsnp_stream([p], device="cpu", method=method))[0][5].tolist() == [1]
        assert port.snp_distance_dense(p, device="cpu", method=method)[0].tolist() == [[0, 1],
                                                                                     [1, 0]]
        return
    with pytest.raises(exc):
        list(port.pairsnp_stream([p], device="cpu", method=method))
    with pytest.raises(exc):
        port.snp_distance_dense(p, device="cpu", method=method)


# -- on the card --

@pytest.mark.cuda
@pytest.mark.parametrize(
    "na,nb,W,r0,rb,c0",
    [(37, None, 17, 0, 37, 0), (48, 14, 17, 5, 37, 3), (300, None, 1000, 100, 130, 64)],
)
def test_popcount_gram_cuda_matches_plain(cuda_device, na, nb, W, r0, rb, c0):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(na * W)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=cuda_device, generator=gen)

    pa = kernels.pad_planes(words(na, 4, W))
    pb = None if nb is None else kernels.pad_planes(words(nb, 4, W))
    before = profiling.counter("kernel.launches.popcount_gram")
    got = kernels.popcount_gram(pa, r0, rb, c0, pb)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.launches.popcount_gram") == before + 1
    want = kernels.popcount_gram_reference(pa, r0, rb, c0, pb)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_popcount_stream_cuda_launches_once_per_block(cuda_device):
    rng = np.random.default_rng(14)
    p = pack_sequences(_seqs(rng, 70, 1000))
    before = profiling.counter("kernel.launches.popcount_gram")
    got = list(port.pairsnp_stream([p], row_block=16, device=cuda_device, method="popcount",
                                   dist=700))
    assert profiling.counter("kernel.launches.popcount_gram") == before + 5
    _assert_streams_equal(got, port.pairsnp_stream([p], row_block=16, device="cpu", dist=700))


def _codes_planes(codes, W):
    """int32 [n, 4, W] planes of samples that hold the 4-bit code codes[k] at
    every site."""
    out = np.zeros((len(codes), 4, W), dtype=np.uint32)
    for k, code in enumerate(codes):
        for x in range(4):
            if code >> x & 1:
                out[k, x] = 0xFFFFFFFF
    return kernels._as_words(out)


@pytest.mark.cuda
def test_popcount_gram_cuda_every_subset_and_sign_decides(cuda_device):
    """Sites that carry 1, 2, 3 and 4 set planes on either side: row S holds
    code S everywhere, so matches[S, T] is every site or none by S & T, and
    every one of the 15 subset grams, with its sign, decides some entry; N
    (code 15) alone counts for nunion."""
    W, codes = 20, list(range(1, 16))
    rng = np.random.default_rng(41)
    mixed = rng.integers(1, 16, size=(9, 32 * W))   # and every code at random sites
    planes = np.zeros((9, 4, W), dtype=np.uint32)
    for x in range(4):
        bits = (mixed >> x & 1).astype(np.uint32).reshape(9, W, 32)
        planes[:, x] = (bits << np.arange(32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)
    pa = torch.cat([_codes_planes(codes, W), kernels._as_words(planes)])
    matches, nunion = kernels.popcount_gram(pa.to(cuda_device), 0, len(pa), 0)
    want = kernels.popcount_gram_reference(pa, 0, len(pa), 0)
    assert torch.equal(matches.cpu(), want[0]) and torch.equal(nunion.cpu(), want[1])
    S = torch.tensor(codes)
    assert torch.equal(matches.cpu()[:15, :15], ((S[:, None] & S[None, :]) != 0).int() * 32 * W)
    assert torch.equal(nunion.cpu()[:15, :15],
                       ((S[:, None] == 15) | (S[None, :] == 15)).int() * 32 * W)


@pytest.mark.cuda
@pytest.mark.parametrize("r0,c0", [(0, 0), (70, 130)])
def test_popcount_gram_cuda_single_bit_walk_over_a_whole_tile(cuda_device, r0, c0):
    """The fragment layout, the swapped halves of the staged rows and the row
    counts: one set bit on each side walked through every word and bit of a
    16-word chunk and every row and column of a 128 x 128 span of outputs (one
    128 x 64 tile and its neighbour), in one plane or, every fifth step, in
    all four (an N)."""
    W, T = 16, 128
    na, nb = r0 + T, c0 + T
    for p in range(W * 32 * 2):
        w, b = divmod(p % (W * 32), 32)
        i, j, x = (p * 5 + p // 128) % T, (p * 3 + p // 64) % T, p % 5   # x = 4: all planes
        pa = torch.zeros((na, 4, W), dtype=torch.int32)
        pb = torch.zeros((nb, 4, W), dtype=torch.int32)
        bit = int(np.uint32(1 << b).view(np.int32))
        other = int(np.uint32(1 << (b ^ 1)).view(np.int32))
        j2 = c0 + (j + 1) % T
        planes = slice(0, 4) if x == 4 else x
        pa[r0 + i, planes, w], pb[c0 + j, planes, w], pb[j2, planes, w] = bit, bit, other
        matches, nunion = kernels.popcount_gram(pa.to(cuda_device), r0, T, c0, pb.to(cuda_device))
        want_m = torch.zeros((T, T), dtype=torch.int32)
        want_u = torch.zeros((T, T), dtype=torch.int32)
        want_m[i, j] = 1
        if x == 4:   # N on row i, on column j and (another site) on column j2
            want_u[i, :] += 1
            want_u[:, j] += 1
            want_u[:, (j + 1) % T] += 1
            want_u[i, j] -= 1
        assert torch.equal(matches.cpu(), want_m) and torch.equal(nunion.cpu(), want_u), (p, i, j, x)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 10**6])
def test_popcount_gram_cuda_word_axis_cuts_are_exact(cuda_device, monkeypatch, splits):
    """The word axis cut into parts that add to zeroed outputs, their share of
    the row counts included: the same integers whatever the cut."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(splits % 1000)
    pa = torch.randint(-2**31, 2**31, (200, 4, 1004), dtype=torch.int32, device=cuda_device,
                       generator=gen)
    pa[:, :, 1001:] = 0
    monkeypatch.setattr(kernels, "_POPCOUNT_GRAM_WORD_SPLITS", splits)
    got = kernels.popcount_gram(pa, 30, 150, 17)
    torch.cuda.synchronize()
    want = kernels.popcount_gram_reference(pa, 30, 150, 17)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_popcount_gram_cuda_refuses_unpadded_and_too_wide(cuda_device):
    with pytest.raises(ValueError, match="pad_planes"):
        kernels.popcount_gram(torch.zeros((4, 4, 5), dtype=torch.int32, device=cuda_device),
                              0, 4, 0)
    wide = torch.zeros((1, 4, kernels._POPCOUNT_GRAM_MAX_WORDS), dtype=torch.int32,
                       device=cuda_device)
    with pytest.raises(ValueError, match="int32 sums"):
        kernels.popcount_gram(wide, 0, 1, 0)
