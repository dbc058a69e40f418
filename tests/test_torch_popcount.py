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
    before = kernels.POPCOUNT_GRAM_LAUNCHES
    kernels.popcount_gram(pa, 0, 5, 0)
    assert kernels.POPCOUNT_GRAM_LAUNCHES == before


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


@pytest.mark.parametrize("method,exc", [("mxu", NotImplementedError), ("bogus", ValueError)])
def test_other_methods_raise(method, exc):
    p = pack_sequences(["ACGT", "ACGA"])
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

    pa = words(na, 4, W)
    pb = None if nb is None else words(nb, 4, W)
    before = kernels.POPCOUNT_GRAM_LAUNCHES
    got = kernels.popcount_gram(pa, r0, rb, c0, pb)
    torch.cuda.synchronize()
    assert kernels.POPCOUNT_GRAM_LAUNCHES == before + 1
    want = kernels.popcount_gram_reference(pa, r0, rb, c0, pb)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_popcount_stream_cuda_launches_once_per_block(cuda_device):
    rng = np.random.default_rng(14)
    p = pack_sequences(_seqs(rng, 70, 1000))
    before = kernels.POPCOUNT_GRAM_LAUNCHES
    got = list(port.pairsnp_stream([p], row_block=16, device=cuda_device, method="popcount",
                                   dist=700))
    assert kernels.POPCOUNT_GRAM_LAUNCHES == before + 5
    _assert_streams_equal(got, port.pairsnp_stream([p], row_block=16, device="cpu", dist=700))
