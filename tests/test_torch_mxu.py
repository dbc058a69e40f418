"""The port's inclusion-exclusion engine (``method="mxu"`` of
ops/pairsnp.py) and its ``auto`` rule against the JAX package: D and NN of
``snp_distance_dense`` and every array of ``pairsnp_stream`` equal
tracs_tpu's ``method="mxu"`` exactly (tolerance 0: all integers), and
``_select_method`` picks what tracs_tpu picks.  The cases are those of
tests/test_pairsnp.py::test_dense_matches_brute_force and
test_chunked_mxu_matches and tests/test_streaming.py::
test_stream_crosscheck_methods_match_split.  On the card the engine is the
popcount kernel: a card-only test checks that it launches there and equals
the split engine.

jax is imported inside the tests that need it, so the card-only test runs on
a machine without it."""

import numpy as np
import pytest
import torch

from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops.packing import from_reference, pack_sequences
from tracs_tpu_torch.runtime import profiling

CPU = "cpu"


@pytest.fixture
def jax_ref():
    """(tracs_tpu packing, tracs_tpu pairsnp)."""
    pytest.importorskip("jax")
    from tracs_tpu.ops import packing as jpacking
    from tracs_tpu.ops import pairsnp as jref

    return jpacking, jref


def _both(jpacking, seqs):
    j = jpacking.pack_sequences(seqs)
    return j, from_reference(j.planes, j.length, j.names)


def _seqs(rng, n, L, alphabet):
    return ["".join(rng.choice(np.array(list(alphabet)), size=L)) for _ in range(n)]


def _collect(stream):
    blocks = list(stream)
    return [np.concatenate([np.asarray(b[k]) for b in blocks]) for k in (3, 4, 5, 6, 7)]


@pytest.mark.parametrize("L", [1, 37, 64, 129, 1000])
def test_dense_mxu_matches_reference(jax_ref, L):
    jpacking, jref = jax_ref
    rng = np.random.default_rng(L)
    j, p = _both(jpacking, _seqs(rng, 11, L, "ACGTMRWSYKVHDBN-acgt"))
    Dj, NNj = jref.snp_distance_dense(j, method="mxu")
    D, NN = port.snp_distance_dense(p, device=CPU, method="mxu", row_block=4)
    assert D.dtype == np.int32 and NN.dtype == np.int32
    assert np.array_equal(D, Dj) and np.array_equal(NN, NNj)


def test_chunked_mxu_matches(jax_ref, monkeypatch):
    """Several word chunks through ``_gram_mxu``'s accumulators."""
    jpacking, jref = jax_ref
    rng = np.random.default_rng(3)
    j, p = _both(jpacking, _seqs(rng, 6, 2048, "ACGTN"))
    monkeypatch.setattr(port, "_PARTIAL_CHUNK_BYTES", 6 * 15 * 32 * 8 * 8)  # 8 words a chunk
    D, NN = port.snp_distance_dense(p, device=CPU, method="mxu")
    Dj, NNj = jref.snp_distance_dense(j, method="mxu", chunk_sites=256)
    assert np.array_equal(D, Dj) and np.array_equal(NN, NNj)
    Dp, NNp = port.snp_distance_dense(p, device=CPU, method="popcount")
    assert np.array_equal(D, Dp) and np.array_equal(NN, NNp)


def test_gram_mxu_is_the_signed_subset_expansion():
    """g = -matches and gq = the N gram, from the 15 plane subsets."""
    rng = np.random.default_rng(4)
    p = pack_sequences(_seqs(rng, 9, 100, "ACGTMRWSYKVHDBN"))
    pa = kernels._as_words(p.planes)
    g, gq = port._gram_mxu(pa, pa)
    matches, nunion = kernels.popcount_gram_reference(pa, 0, 9, 0)
    cnt = port._cnt_n(p, 0, None)
    assert torch.equal(g, -matches)
    assert torch.equal(gq, cnt[:, None] + cnt[None, :] - nunion)


def test_n_counts_of_a_row_range_count_the_n_sites():
    """``_cnt_n`` on row ranges, with an all-N row, a ragged tail and '-'
    (packed as N), against the N characters of the sequences."""
    rng = np.random.default_rng(8)
    seqs = _seqs(rng, 5, 1001, "ACGTN-") + ["N" * 1001]
    p = pack_sequences(seqs)
    want = [s.count("N") + s.count("-") for s in seqs]
    got = port._cnt_n(p, 0, None)
    assert got.dtype == torch.int32 and got.tolist() == want
    assert port._cnt_n(p, 2, 5).tolist() == want[2:5]
    assert port._cnt_n(p, 4, None).tolist() == want[4:] and want[-1] == 1001


@pytest.mark.parametrize("filter_", [False, True])
def test_stream_mxu_matches_reference(jax_ref, filter_):
    """tests/test_streaming.py::test_stream_crosscheck_methods_match_split:
    streaming blocks, a selective threshold, the filter, and two FASTAs."""
    jpacking, jref = jax_ref
    rng = np.random.default_rng(12345)
    seqs = _seqs(rng, 10, 257, "ACGTNRY")
    j, p = _both(jpacking, seqs)
    want = _collect(jref.pairsnp_stream([j], dist=120, filter=filter_, method="mxu",
                                        row_block=3))
    got = _collect(port.pairsnp_stream([p], dist=120, filter=filter_, method="mxu",
                                       row_block=3, device=CPU))
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    (ja, pa), (jb, pb) = _both(jpacking, seqs[:6]), _both(jpacking, seqs[6:])
    want = _collect(jref.pairsnp_stream([ja, jb], dist=150, method="mxu", row_block=2))
    got = _collect(port.pairsnp_stream([pa, pb], dist=150, method="mxu", row_block=2,
                                       device=CPU))
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    split = _collect(port.pairsnp_stream([pa, pb], dist=150, method="split", row_block=2,
                                         device=CPU))
    for s, g in zip(split, got):
        assert np.array_equal(s, g)


@pytest.mark.parametrize("case", ["ordinary", "all_partial", "95%_partial"])
def test_select_method_chooses_as_reference(jax_ref, case):
    """``auto`` runs the engine tracs_tpu runs, on an ordinary alignment and on
    ones whose sites are all or 95% partial-IUPAC.  tracs_tpu's rule picks mxu
    only where 10 p >= 11 L (p partial sites of L), which no alignment meets,
    so both packages run split on all three."""
    jpacking, jref = jax_ref
    rng = np.random.default_rng(5)
    alphabet = "ACGTN" if case == "ordinary" else "MRWSYKVHDB"
    seqs = _seqs(rng, 8, 320, alphabet)
    if case == "95%_partial":
        for k in range(0, 320, 20):  # 5% of the columns plain
            seqs = [s[:k] + "A" + s[k + 1:] for s in seqs]
    j, p = _both(jpacking, seqs)
    want = jref._select_method(j, j)
    assert want == "split"
    assert port._select_method(p, p) == want
    assert port._engine("auto", p, p) == want
    D, NN = port.snp_distance_dense(p, device=CPU, method="auto")
    Dj, NNj = jref.snp_distance_dense(j, method="auto")
    assert np.array_equal(D, Dj) and np.array_equal(NN, NNj)


def test_unknown_method_raises():
    p = pack_sequences(["ACGT", "ACGA"])
    with pytest.raises(ValueError, match="unknown method"):
        list(port.pairsnp_stream([p], device=CPU, method="bogus"))


# -- on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_mxu_on_the_card_launches_popcount_gram_and_equals_split(cuda_device, monkeypatch):
    rng = np.random.default_rng(6)
    seqs = _seqs(rng, 70, 1500, "ACGTMRWSYKVHDBN-")
    want = _collect(port.pairsnp_stream([pack_sequences(seqs)], dist=1200, filter=True,
                                        method="split", row_block=32, device=cuda_device))
    before = profiling.counter("kernel.launches.popcount_gram")
    got = _collect(port.pairsnp_stream([pack_sequences(seqs)], dist=1200, filter=True,
                                       method="mxu", row_block=32, device=cuda_device))
    assert profiling.counter("kernel.launches.popcount_gram") == before + 3
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    D, NN = port.snp_distance_dense(pack_sequences(seqs), device=cuda_device, method="mxu")
    Dc, NNc = port.snp_distance_dense(pack_sequences(seqs), device=CPU, method="mxu")
    assert np.array_equal(D, Dc) and np.array_equal(NN, NNc)
