"""The port's correction gram (ops/kernels.py ``partial_gram``: the signed sum
of the 6 plane-pair and 4 plane-triple AND grams over the partial-IUPAC
sites) against the JAX package's ``_gram_partial`` on the same numpy-seeded
words, and the split engine around it against tracs_tpu.  Tolerance 0: every
output is an integer.  The CUDA kernel (the 10 grams on the b1 tensor
cores) is held against its plain version where a card exists, on one-bit
walks across its tile edges, all 16 x 16 codes and word counts across its k
steps.  The function's per-site identity (the 10
products add up to -([k >= 2] + [k >= 3]) for k planes in common), which the
card's all-codes case takes as its expected value, is held against
``_gram_partial`` here through a numpy model of it.

jax is imported inside the tests that need it, so the card-only tests run on
a machine without it."""

import numpy as np
import pytest
import torch

from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops.packing import from_reference, popcount_words, split_alignment
from tracs_tpu_torch.runtime import profiling

IUPAC = np.array(list("ACGTMRWSYKVHDBN-"))
#: the partial-site word counts of the cases: one word, a ragged few, and the
#: headline's 2048 partial sites
WORD_COUNTS = [1, 3, 64]
#: word counts below, at and past the card's pitch of 4 words
PADDED_WORD_COUNTS = [1, 3, 4, 5, 17, 64]


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tracs_tpu.ops import packing as jpacking
    from tracs_tpu.ops import pairsnp as jref

    return jnp, jpacking, jref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_words(rng, n, Wp):
    """uint32 [n, 4, Wp]: every bit pattern, 4-plane sites included."""
    return rng.integers(0, 2**32, size=(n, 4, Wp), dtype=np.uint64).astype(np.uint32)


def _seqs_with_partial(rng, n, Wp):
    """Sequences whose union of partial-IUPAC sites fills ``Wp`` words: 32 * Wp
    - 5 partial columns in a conserved genome (exactly 2048 = 64 words at
    Wp = 64)."""
    n_partial = 32 * Wp if Wp == 64 else 32 * Wp - 5
    L = n_partial + 300
    base = rng.choice(np.array(list("ACGT")), size=L)
    cols = rng.choice(L, size=n_partial, replace=False)
    seqs = np.repeat(base[None, :], n, axis=0)
    noise = rng.random((n, L)) < 0.05
    seqs[noise] = rng.choice(np.array(list("ACGTN-")), size=int(noise.sum()))
    owner = rng.integers(0, n, size=n_partial)
    seqs[owner, cols] = rng.choice(np.array(list("MRWSYKVHDB")), size=n_partial)
    return ["".join(s) for s in seqs]


def _jax_gram(jax_ref, a, b):
    jnp, _, jref = jax_ref
    return np.asarray(jref._gram_partial(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("Wp", WORD_COUNTS)
@pytest.mark.parametrize("na,nb", [(1, 1), (9, 23), (70, 5), (0, 4)])
def test_partial_gram_random_words_match_reference(jax_ref, na, nb, Wp):
    rng = np.random.default_rng([na, nb, Wp])
    a, b = _random_words(rng, na, Wp), _random_words(rng, nb, Wp)
    got = kernels.partial_gram(kernels._as_words(a), kernels._as_words(b))
    assert got.dtype == torch.int32 and got.shape == (na, nb)
    if na:
        assert np.array_equal(got.numpy(), _jax_gram(jax_ref, a, b))


@pytest.mark.parametrize("Wp", WORD_COUNTS)
@pytest.mark.parametrize("r0,r1,c0", [(0, 11, 0), (3, 8, 3), (10, 11, 2)])
def test_partial_gram_of_a_layout_matches_reference(jax_ref, Wp, r0, r1, c0):
    """The split layout's own partial planes, the rows and column suffix of a
    sweep block, as ``_split_grams`` slices them."""
    _, jpacking, _ = jax_ref
    rng = np.random.default_rng(Wp + r0)
    j = jpacking.pack_sequences(_seqs_with_partial(rng, 11, Wp))
    sa = split_alignment(from_reference(j.planes, j.length, j.names))
    pt = port._split_device(sa, torch.device("cpu"))[2]
    want = np.asarray(jpacking.split_alignment(j).partial)
    assert want.shape[2] == Wp and sa.n_partial == (32 * Wp if Wp == 64 else 32 * Wp - 5)
    words = pt.numpy().view(np.uint32)
    assert np.array_equal(words[..., :Wp], want) and not words[..., Wp:].any()
    got = kernels.partial_gram(pt[r0:r1], pt[c0:])
    assert np.array_equal(got.numpy(), _jax_gram(jax_ref, want[r0:r1], want[c0:]))


def _identity_model(a, b):
    """numpy model of the per-site identity: per word pair, x_p = a_p & b_p,
    the carry-save half adders of x_0 + x_1 and x_2 + x_3, and
    -(popc(k >= 2) + popc(k >= 3))."""
    x = a[:, None] & b[None, :]  # [na, nb, 4, Wp]
    c1, s1 = x[:, :, 0] & x[:, :, 1], x[:, :, 0] ^ x[:, :, 1]
    c2, s2 = x[:, :, 2] & x[:, :, 3], x[:, :, 2] ^ x[:, :, 3]
    ge2 = c1 | c2 | (s1 & s2)
    ge3 = (c1 & c2) | ((c1 | c2) & (s1 | s2))
    return -(popcount_words(ge2).sum(-1) + popcount_words(ge3).sum(-1)).astype(np.int64)


@pytest.mark.parametrize("Wp", WORD_COUNTS)
def test_kernel_identity_matches_reference(jax_ref, Wp):
    """The identity's 4 ANDs and 2 POPC a word pair give the 10-channel gram
    on every bit pattern: sites with 0 to 4 planes in common on random words,
    and each of the 16 codes against each on whole words."""
    rng = np.random.default_rng(Wp)
    a, b = _random_words(rng, 13, Wp), _random_words(rng, 17, Wp)
    assert np.array_equal(_identity_model(a, b), _jax_gram(jax_ref, a, b))
    codes = np.zeros((16, 4, Wp), dtype=np.uint32)
    for code in range(16):
        for x in range(4):
            if code >> x & 1:
                codes[code, x] = 0xFFFFFFFF
    want = _jax_gram(jax_ref, codes, codes)
    assert np.array_equal(_identity_model(codes, codes), want)
    k = np.array([[bin(s & t).count("1") for t in range(16)] for s in range(16)])
    per_site = np.array([0, 0, -1, -2, -2])[k]
    assert np.array_equal(want, per_site * 32 * Wp)


def test_reference_chunking_is_exact(monkeypatch):
    """One-word chunks (the memory bound at its tightest) give the same gram
    as one chunk."""
    rng = np.random.default_rng(2)
    a = kernels._as_words(_random_words(rng, 7, 5))
    b = kernels._as_words(_random_words(rng, 9, 5))
    want = kernels.partial_gram_reference(a, b)
    monkeypatch.setattr(kernels, "_REFERENCE_BYTES", 1)
    assert torch.equal(kernels.partial_gram_reference(a, b), want)


@pytest.mark.parametrize("Wp", WORD_COUNTS)
@pytest.mark.parametrize("two", [False, True], ids=["self", "query-vs-db"])
def test_split_engine_with_partial_sites_matches_reference(jax_ref, Wp, two):
    """The slice as a whole on partial-heavy alignments: the dense matrices
    and the stream of the split engine (K1, ``partial_gram``, ``coo_extract``)
    equal tracs_tpu's."""
    _, jpacking, jref = jax_ref
    rng = np.random.default_rng(40 + Wp)
    seqs = _seqs_with_partial(rng, 14, Wp)
    ja = jpacking.pack_sequences(seqs[:9] if two else seqs)
    jb = jpacking.pack_sequences(seqs[9:]) if two else None
    pa = from_reference(ja.planes, ja.length, ja.names)
    pb = from_reference(jb.planes, jb.length, jb.names) if two else None
    D, NN = port.snp_distance_dense(pa, pb, device="cpu", row_block=4)
    Dj, NNj = jref.snp_distance_dense(ja, jb, method="split")
    assert np.array_equal(D, Dj) and np.array_equal(NN, NNj)
    dist = int(np.median(Dj))
    fasta_j, fasta_p = ([ja, jb], [pa, pb]) if two else ([ja], [pa])
    want = list(jref.pairsnp_stream(fasta_j, dist=dist, method="split", row_block=4))
    before = profiling.counter("kernel.launches.partial_gram")
    got = list(port.pairsnp_stream(fasta_p, dist=dist, device="cpu", row_block=4,
                                   compact=False))
    assert profiling.counter("kernel.launches.partial_gram") == before  # the CPU counts no launch
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for k in range(3, 8):
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


@pytest.mark.parametrize("Wp", PADDED_WORD_COUNTS)
def test_padded_partial_planes_match_reference(jax_ref, Wp):
    """Partial planes at the card's word pitch (``pad_planes``: zero words up
    to a multiple of 4) give tracs_tpu's gram of the unpadded words, whole and
    as the rows and column suffix a sweep block slices."""
    rng = np.random.default_rng(60 + Wp)
    a, b = _random_words(rng, 13, Wp), _random_words(rng, 21, Wp)
    pa, pb = kernels.pad_planes(kernels._as_words(a)), kernels.pad_planes(kernels._as_words(b))
    assert pa.shape[2] == kernels.padded_words(Wp) and pa.shape[2] % 4 == 0
    assert np.array_equal(kernels.partial_gram(pa, pb).numpy(), _jax_gram(jax_ref, a, b))
    assert np.array_equal(kernels.partial_gram(pa[2:9], pb[5:]).numpy(),
                          _jax_gram(jax_ref, a[2:9], b[5:]))


@pytest.mark.parametrize("Wp", PADDED_WORD_COUNTS)
def test_split_stream_on_padded_partial_planes_matches_reference(jax_ref, Wp):
    """The split engine's stream, whose resident partial planes now carry the
    card's pitch, yields tracs_tpu's arrays."""
    _, jpacking, jref = jax_ref
    rng = np.random.default_rng(70 + Wp)
    j = jpacking.pack_sequences(_seqs_with_partial(rng, 13, Wp))
    p = from_reference(j.planes, j.length, j.names)
    sa = port._split_pair(p, None)[0]
    pt = port._split_device(sa, torch.device("cpu"))[2]
    assert jpacking.split_alignment(j).partial.shape[2] == Wp
    assert pt.shape[2] == kernels.padded_words(Wp)
    dist = int(np.median(np.asarray(jref.snp_distance_dense(j, None, method="split")[0])))
    want = list(jref.pairsnp_stream([j], dist=dist, method="split", row_block=4))
    got = list(port.pairsnp_stream([p], dist=dist, device="cpu", row_block=4, compact=False))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for k in range(3, 8):
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


@pytest.mark.parametrize("rows,words,refused", [
    (1, 2**23, True),                      # the pairs' int32 sums overflow
    (65535 * 128 + 1, 4, True),           # past the grid's rows
    (1, 2**23 - 4, False),                # inside both: refused later, as not a card
])
def test_word_limit_refused(rows, words, refused):
    """The kernel's range is checked before any card is needed: on ``meta``
    tensors, which hold no memory."""
    a = torch.empty((rows, 4, words), dtype=torch.int32, device="meta")
    b = torch.empty((3, 4, words), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="fewer than 8388608 words" if refused
                       else "runs on cuda or cpu"):
        kernels.partial_gram(a, b)


def test_refusals():
    rng = np.random.default_rng(4)
    a = kernels._as_words(_random_words(rng, 5, 3))
    b = kernels._as_words(_random_words(rng, 6, 3))
    with pytest.raises(TypeError, match="int32"):
        kernels.partial_gram(a.long(), b)
    with pytest.raises(ValueError, match=r"\[n, 4, W\]"):
        kernels.partial_gram(a[:, :3].contiguous(), b)
    with pytest.raises(ValueError, match="words"):
        kernels.partial_gram(a, b[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.partial_gram(a, b[:, :, ::2])


def test_a_device_without_a_kernel_raises():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on the
    ``meta`` device gets no plain version."""
    a = torch.empty((5, 4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        kernels.partial_gram(a, a)


# -- on the card --

@pytest.mark.cuda
@pytest.mark.parametrize("na,nb,Wp", [(1, 1, 1), (37, 70, 3), (65, 129, 64), (300, 33, 100),
                                      (1024, 200, 9)])
def test_partial_gram_cuda_matches_plain(cuda_device, na, nb, Wp):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(na * Wp)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=cuda_device,
                             generator=gen)

    # at the card's word pitch, as the layouts hold them (zero words past Wp)
    a, b = kernels.pad_planes(words(na, 4, Wp)), kernels.pad_planes(words(nb, 4, Wp))
    before = profiling.counter("kernel.launches.partial_gram")
    got = kernels.partial_gram(a, b)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.launches.partial_gram") == before + 1
    assert torch.equal(got, kernels.partial_gram_reference(a, b))
    # rows of a resident layout, as the sweep slices them: storage offsets
    assert torch.equal(kernels.partial_gram(a[1:], b[na // 3:]),
                       kernels.partial_gram_reference(a[1:], b[na // 3:]))


@pytest.mark.cuda
def test_split_stream_cuda_launches_partial_gram_each_block(cuda_device):
    rng = np.random.default_rng(9)
    from tracs_tpu_torch.ops.packing import pack_sequences

    p = pack_sequences(_seqs_with_partial(rng, 70, 3))
    before = profiling.counter("kernel.launches.partial_gram")
    got = list(port.pairsnp_stream([p], row_block=16, device=cuda_device, dist=60))
    assert profiling.counter("kernel.launches.partial_gram") == before + 5
    want = list(port.pairsnp_stream([p], row_block=16, device="cpu", dist=60))
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert all(np.array_equal(x, y) for x, y in zip(g[3:], w[3:]))


#: columns of the kernel's block tile (128 rows x 64 columns)
TILE_COLS = 64


@pytest.mark.cuda
def test_partial_gram_cuda_one_bit_walk(cuda_device):
    """One site of one A row holds a 3-plane code and one site of one B row
    holds N (4 planes): only that pair shares 3 planes, at that site, and
    gains -2.  The site walks across the fragments' k slots and the k256
    steps and chunks, the rows and columns across the tiles' edges."""
    tile = TILE_COLS
    Wp, na, nb = 72, 260, 2 * tile + 3
    rows = [0, 1, 7, 8, 15, 16, 31, 32, 127, 128, 129, na - 1]
    cols = [0, 1, 7, 8, 31, 32, tile - 1, tile, tile + 1, nb - 1]
    words = [0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, Wp - 1]
    for k, (r, c) in enumerate((r, c) for r in rows for c in cols):
        w, bit = words[k % len(words)], (5 * k) % 32
        a = torch.zeros((na, 4, Wp), dtype=torch.int32, device=cuda_device)
        b = torch.zeros((nb, 4, Wp), dtype=torch.int32, device=cuda_device)
        word = torch.tensor(1 << bit, dtype=torch.int64).to(torch.int32).item()
        a[r, :3, w] = word
        b[c, :, w] = word
        got = kernels.partial_gram(a, b)
        want = torch.zeros((na, nb), dtype=torch.int32, device=cuda_device)
        want[r, c] = -2
        assert torch.equal(got, want), (r, c, w, bit)


@pytest.mark.cuda
def test_partial_gram_cuda_all_codes(cuda_device):
    """Each of the 16 x 16 four-bit codes against each, on whole words: a
    site with k planes in common adds C(k, 3) - C(k, 2)."""
    Wp = 12
    codes = torch.zeros((16, 4, Wp), dtype=torch.int32)
    for code in range(16):
        for x in range(4):
            if code >> x & 1:
                codes[code, x] = -1
    got = kernels.partial_gram(codes.to(cuda_device), codes.to(cuda_device)).cpu()
    k = np.array([[bin(s & t).count("1") for t in range(16)] for s in range(16)])
    assert np.array_equal(got.numpy(), np.array([0, 0, -1, -2, -2])[k] * 32 * Wp)


@pytest.mark.cuda
@pytest.mark.parametrize("Wp", [1, 7, 8, 9, 16, 25, 31, 32, 33, 40, 64, 65, 100])
def test_partial_gram_cuda_word_counts_cross_k_steps(cuda_device, Wp):
    """Word counts across each k256 step (8 words) and chunk (32 words) of
    the ring, padded to the card's pitch: equal to the plain version."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(Wp)
    a, b = (kernels.pad_planes(torch.randint(-2**31, 2**31, (n, 4, Wp), dtype=torch.int32,
                                             device=cuda_device, generator=gen))
            for n in (150, 200))
    assert torch.equal(kernels.partial_gram(a, b), kernels.partial_gram_reference(a, b))


@pytest.mark.cuda
def test_partial_gram_cuda_word_axis_cut(cuda_device, monkeypatch):
    """The word axis cut into parts that add with atomics: the same integers."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    a, b = (torch.randint(-2**31, 2**31, (n, 4, 4096), dtype=torch.int32, device=cuda_device,
                          generator=gen) for n in (70, 90))
    want = kernels.partial_gram_reference(a, b)
    for splits in (0, 1, 3, 16):
        monkeypatch.setattr(kernels, "_PARTIAL_GRAM_WORD_SPLITS", splits)
        assert torch.equal(kernels.partial_gram(a, b), want), splits


@pytest.mark.cuda
def test_partial_gram_cuda_refuses_the_pitch(cuda_device):
    """An operand whose word pitch is no multiple of 4, or whose storage is
    not 16-byte aligned, is refused by name, not copied."""
    a = torch.zeros((5, 4, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="part_a.*pad_planes"):
        kernels.partial_gram(a, torch.zeros((6, 4, 3), dtype=torch.int32, device=cuda_device))
    b = kernels.pad_planes(torch.zeros((6, 4, 3), dtype=torch.int32, device=cuda_device))
    shifted = torch.zeros(6 * 16 + 1, dtype=torch.int32, device=cuda_device)[1:].view(6, 4, 4)
    with pytest.raises(ValueError, match="part_b.*16-byte aligned"):
        kernels.partial_gram(b, shifted)
