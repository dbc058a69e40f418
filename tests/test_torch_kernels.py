"""The port's split-gram kernel (tracs_tpu_torch/ops/kernels.py) against the
JAX package's grams: the Pallas kernel K1 in interpret mode and the XLA
twins ``_dense_split`` / ``_dense_split_ranged``.  Tolerance 0: every
output is an integer.  Also pins the torch behaviours the port is built
around, and checks the CUDA kernel against its plain version where a card
exists."""

import numpy as np
import pytest
import torch

from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops.packing import pack_sequences, split_alignment
from tracs_tpu_torch.runtime import profiling

IUPAC = np.array(list("ACGTMRWSYKVHDBN-"))


def _words(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _seqs(rng, n, L, alphabet=IUPAC):
    return ["".join(rng.choice(alphabet, size=L)) for _ in range(n)]


def _split_words(seqs):
    """(excl, nmask) int32 CPU tensors of the port's split layout of
    ``seqs``, at the card's word pitch."""
    from tracs_tpu_torch.ops.pairsnp import _split_device

    return _split_device(split_alignment(pack_sequences(seqs)), torch.device("cpu"))[:2]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("na,nb,L", [(37, 37, 533), (37, 11, 533), (130, 5, 9000)])
def test_split_gram_matches_pallas_and_xla(na, nb, L):
    """Full-matrix grams: port wrapper (CPU -> plain version) and the plain
    version itself equal Pallas K1 (interpret) and XLA _dense_split."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tracs_tpu.ops.packing import pack_sequences as jax_pack
    from tracs_tpu.ops.packing import split_alignment as jax_split
    from tracs_tpu.ops.pairsnp import _dense_split
    from tracs_tpu.ops.pallas_kernels import split_gram_pallas

    rng = np.random.default_rng(na * 1000 + nb)
    qa = _seqs(rng, na, L)
    qb = qa if nb == na else _seqs(rng, nb, L)
    sa = jax_split(jax_pack(qa))
    sb = sa if nb == na else jax_split(jax_pack(qb))

    gp, gnp = split_gram_pallas(sa.excl, sa.nmask, sb.excl, sb.nmask, interpret=True)
    W = sa.excl.shape[2]
    gx, gnx = _dense_split(
        jnp.asarray(sa.excl), jnp.asarray(sa.nmask), jnp.asarray(sb.excl),
        jnp.asarray(sb.nmask), wc=W, n_chunks=1, with_nn=True,
    )

    ea, nm = _split_words(qa)
    eb, nmb = (None, None) if nb == na else _split_words(qb)
    g, gn = kernels.split_gram(ea, nm, 0, na, 0, eb, nmb)
    g0, gn0 = kernels.split_gram_reference(ea, nm, 0, na, 0, eb, nmb)
    assert g.dtype == gn.dtype == torch.int32
    for got in (g.numpy(), g0.numpy()):
        assert np.array_equal(got, gp) and np.array_equal(got, np.asarray(gx))
    for got in (gn.numpy(), gn0.numpy()):
        assert np.array_equal(got, gnp) and np.array_equal(got, np.asarray(gnx))


@pytest.mark.parametrize(
    "n,L,r0,rb,c0",
    [(37, 533, 5, 20, 9), (64, 700, 32, 32, 32), (50, 300, 49, 1, 0), (41, 97, 0, 41, 40)],
)
def test_split_gram_ranged_matches_xla(n, L, r0, rb, c0):
    """Row-block x column-suffix addressing at r0 > 0, c0 > 0 and ragged W
    equals _dense_split_ranged, which reads the same full layout."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tracs_tpu.ops.pairsnp import _dense_split_ranged

    from tracs_tpu.ops.packing import pack_sequences as jax_pack
    from tracs_tpu.ops.packing import split_alignment as jax_split

    rng = np.random.default_rng(n + L + r0)
    seqs = _seqs(rng, n, L)
    sa = jax_split(jax_pack(seqs))
    W = sa.excl.shape[2]
    assert W * 32 != L  # a ragged last word
    gx, gnx = _dense_split_ranged(
        jnp.asarray(sa.excl), jnp.asarray(sa.nmask), jnp.int32(r0),
        rb=rb, c0=c0, wc=8, n_chunks=-(-W // 8),
    )
    g, gn = kernels.split_gram(*_split_words(seqs), r0, rb, c0)
    assert g.shape == (rb, n - c0)
    assert np.array_equal(g.numpy(), np.asarray(gx))
    assert np.array_equal(gn.numpy(), np.asarray(gnx))


def test_split_gram_reference_chunking_is_exact(monkeypatch):
    """One-word chunks (the memory bound at its tightest) give the same
    grams as one chunk."""
    rng = np.random.default_rng(7)
    ea, nm = _split_words(_seqs(rng, 23, 250))
    want = kernels.split_gram_reference(ea, nm, 3, 15, 4)
    monkeypatch.setattr(kernels, "_REFERENCE_BYTES", 1)
    got = kernels.split_gram_reference(ea, nm, 3, 15, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_call_counts_no_launch():
    rng = np.random.default_rng(3)
    ea, nm = _split_words(_seqs(rng, 5, 64))
    before = profiling.counter("kernel.launches.split_gram")
    kernels.split_gram(ea, nm, 0, 5, 0)
    assert profiling.counter("kernel.launches.split_gram") == before


@pytest.mark.parametrize(
    "case",
    ["int64", "shape", "mask_shape", "noncontig", "rows", "cols", "eb_alone", "words", "meta"],
)
def test_split_gram_rejects_bad_inputs(case):
    ea = torch.zeros((6, 4, 3), dtype=torch.int32)
    nm = torch.zeros((6, 3), dtype=torch.int32)
    args = dict(ea=ea, nm=nm, r0=0, rb=6, c0=0, eb=None, nmb=None)
    if case == "int64":
        args["ea"] = ea.long()
    elif case == "shape":
        args["ea"] = torch.zeros((6, 3, 3), dtype=torch.int32)
    elif case == "mask_shape":
        args["nm"] = torch.zeros((6, 2), dtype=torch.int32)
    elif case == "noncontig":
        args["ea"] = torch.zeros((6, 4, 6), dtype=torch.int32)[:, :, ::2]
    elif case == "rows":
        args["r0"] = 2
    elif case == "cols":
        args["c0"] = 7
    elif case == "eb_alone":
        args["eb"] = ea
    elif case == "words":
        args["eb"], args["nmb"] = torch.zeros((2, 4, 4), dtype=torch.int32), torch.zeros(
            (2, 4), dtype=torch.int32)
    elif case == "meta":
        args["ea"], args["nm"] = ea.to("meta"), nm.to("meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.split_gram(**args)


# -- the card layout's word pitch --

PITCH_WORDS = [1, 3, 4, 5, 17]


@pytest.mark.parametrize("W", PITCH_WORDS)
def test_pad_layout_pads_with_zero_words(W):
    rng = np.random.default_rng(W)
    e = _words(rng.integers(0, 2**32, size=(5, 4, W), dtype=np.uint32))
    nm = _words(rng.integers(0, 2**32, size=(5, W), dtype=np.uint32))
    pe, pn = kernels.pad_layout(e, nm)
    Wp = kernels.padded_words(W)
    assert Wp % kernels.LAYOUT_WORD_MULTIPLE == 0 and 0 <= Wp - W < kernels.LAYOUT_WORD_MULTIPLE
    assert pe.shape == (5, 4, Wp) and pn.shape == (5, Wp)
    assert pe.is_contiguous() and pn.is_contiguous()
    assert torch.equal(pe[:, :, :W], e) and torch.equal(pn[:, :W], nm)
    assert not pe[:, :, W:].any() and not pn[:, W:].any()
    if Wp == W:
        assert pe is e and pn is nm  # nothing is copied


@pytest.mark.parametrize("W", PITCH_WORDS)
def test_split_gram_on_padded_layout_matches_unpadded_and_pallas(W):
    """Zero words up to the card's pitch add nothing: the grams of the padded
    layout equal those of the unpadded one and Pallas K1's (interpret)."""
    pytest.importorskip("jax")
    from tracs_tpu.ops.packing import pack_sequences as jax_pack
    from tracs_tpu.ops.packing import split_alignment as jax_split
    from tracs_tpu.ops.pallas_kernels import split_gram_pallas

    rng = np.random.default_rng(100 + W)
    L = 32 * W - 7
    qa, qb = _seqs(rng, 19, L), _seqs(rng, 7, L)
    ja, jb = jax_split(jax_pack(qa)), jax_split(jax_pack(qb))
    gp, gnp = split_gram_pallas(ja.excl, ja.nmask, jb.excl, jb.nmask, interpret=True)

    a, b = (_words(ja.excl), _words(ja.nmask)), (_words(jb.excl), _words(jb.nmask))
    assert a[0].shape[2] == W
    want = kernels.split_gram(*a, 3, 11, 2, *b)
    got = kernels.split_gram(*kernels.pad_layout(*a), 3, 11, 2, *kernels.pad_layout(*b))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert np.array_equal(got[0].numpy(), gp[3:14, 2:])
    assert np.array_equal(got[1].numpy(), gnp[3:14, 2:])


@pytest.mark.parametrize("W", PITCH_WORDS)
def test_check_layout_pitch_rule(W):
    """Off the CPU the gram wrappers refuse a word pitch that is not a
    multiple of LAYOUT_WORD_MULTIPLE, with a message that names the remedy;
    CPU tensors of any width go to the plain version.  (``meta`` tensors stand
    in for the card here: the rule reads only the device type and the shape.)"""
    e = torch.zeros((6, 4, W), dtype=torch.int32)
    nm = torch.zeros((6, W), dtype=torch.int32)
    kernels._check_layout(e, nm, "A", pitch=True)
    kernels.split_gram(e, nm, 0, 6, 0)
    kernels._check_layout(e.to("meta"), nm.to("meta"), "A")  # the rule is the gram kernels'
    if W % kernels.LAYOUT_WORD_MULTIPLE:
        for call in (lambda: kernels._check_layout(e.to("meta"), nm.to("meta"), "A", pitch=True),
                     lambda: kernels.split_gram(e.to("meta"), nm.to("meta"), 0, 6, 0),
                     lambda: kernels.split_gram_variant(e.to("meta"), nm.to("meta"), 0, 6, 0,
                                                        dot="b1", tile=128)):
            with pytest.raises(ValueError, match=r"multiple of 4.*pad_layout"):
                call()
    else:
        kernels._check_layout(e.to("meta"), nm.to("meta"), "A", pitch=True)


# -- torch behaviours the port is built around (probed on torch 2.13 CPU) --

def test_trap_int8_mm_wraps():
    """int8 torch.mm returns int8 and wraps: 200 ones sum to -56.  The port
    contracts 0/1 bits in float64 instead."""
    ones = torch.ones((1, 200), dtype=torch.int8)
    out = torch.mm(ones, ones.T)
    assert out.dtype == torch.int8 and int(out) == 200 - 256
    bits = torch.full((1, 4, 7), -1, dtype=torch.int32)  # 224 set bits per plane
    g, gn = kernels.split_gram_reference(bits, bits[:, 0].contiguous(), 0, 1, 0)
    assert int(gn) == 224 and int(g) == 4 * 224 - 224


def test_trap_no_uint32_shift():
    """``>>`` is not implemented for uint32 on the CPU; the port unpacks
    words through a uint8 view, sign bit included."""
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.tensor([5], dtype=torch.uint32) >> 1
    words = torch.tensor([-1, -(2**31), 1, 0x55555555], dtype=torch.int32)
    bits = kernels._unpack_bits(words).reshape(4, 32).sum(dim=1)
    assert bits.tolist() == [32, 1, 1, 16]


def test_trap_no_popcount_op():
    """torch has no popcount op; the plain versions count bits by
    contracting unpacked bits, which equals a numpy popcount."""
    from tracs_tpu_torch.ops.packing import popcount_words

    assert not hasattr(torch, "bitwise_count")
    rng = np.random.default_rng(11)
    w = rng.integers(0, 2**32, size=(9, 5), dtype=np.uint32)
    _, gn = kernels.split_gram_reference(
        torch.zeros((9, 4, 5), dtype=torch.int32), _words(w), 0, 9, 0)
    want = popcount_words(w[:, None, :] & w[None, :, :]).sum(axis=-1)
    assert np.array_equal(gn.numpy(), want)


def test_trap_int32_cumsum_promotes():
    """torch.cumsum of int32 returns int64 (the JAX compaction's flat index
    is int32 by contract); the port compacts with torch.nonzero, whose
    row-major order is the emission order."""
    assert torch.cumsum(torch.ones(3, dtype=torch.int32), 0).dtype == torch.int64
    mask = torch.tensor([[0, 1, 1], [1, 0, 1]], dtype=torch.bool)
    assert torch.nonzero(mask).tolist() == [[0, 1], [0, 2], [1, 0], [1, 2]]


# -- on the card --

def _cuda_words(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=device,
                             generator=gen)
    return words


@pytest.mark.cuda
@pytest.mark.parametrize(
    "na,nb,W,r0,rb,c0",
    [(37, None, 17, 0, 37, 0), (48, 14, 17, 5, 37, 3), (300, None, 1000, 100, 130, 64),
     (700, None, 301, 0, 300, 60)],
)
def test_split_gram_cuda_matches_plain(cuda_device, na, nb, W, r0, rb, c0):
    words = _cuda_words(cuda_device, na * W)
    ea, nm = kernels.pad_layout(words(na, 4, W), words(na, W))
    eb, nmb = (None, None) if nb is None else kernels.pad_layout(words(nb, 4, W), words(nb, W))
    before = profiling.counter("kernel.launches.split_gram")
    g, gn = kernels.split_gram(ea, nm, r0, rb, c0, eb, nmb)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.launches.split_gram") == before + 1
    g0, gn0 = kernels.split_gram_reference(ea, nm, r0, rb, c0, eb, nmb)
    assert torch.equal(g, g0) and torch.equal(gn, gn0)


@pytest.mark.cuda
def test_split_gram_cuda_refuses_an_unpadded_layout(cuda_device):
    words = _cuda_words(cuda_device, 1)
    ea, nm = words(9, 4, 17), words(9, 17)
    before = profiling.counter("kernel.launches.split_gram")
    with pytest.raises(ValueError, match="pad_layout"):
        kernels.split_gram(ea, nm, 0, 9, 0)
    assert profiling.counter("kernel.launches.split_gram") == before
    # 16-byte alignment of the storage is part of the rule
    flat = words(9 * 4 * 20 + 1)
    with pytest.raises(ValueError, match="pad_layout"):
        kernels.split_gram(flat[1:].view(9, 4, 20), words(9, 20), 0, 9, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r0,c0", [(0, 0), (70, 130)])
def test_split_gram_cuda_single_bit_walk(cuda_device, r0, c0):
    """One set bit on each side walked through every word and bit of a
    16-word chunk and every row and column of a whole 128 x 128 tile, through
    all five planes.  A bit that a lane stages to the wrong row, files under
    the wrong k slot or accumulates into another warp's sub-tile lands in
    another output or meets no partner."""
    W, T = 16, 128
    na, nb = r0 + T, c0 + T
    for p in range(W * 32 * 2):
        w, b = divmod(p % (W * 32), 32)
        i, j, x = (p * 5 + p // 128) % T, (p * 3 + p // 64) % T, p % 5   # plane 4 is the N mask
        ea = torch.zeros((na, 4, W), dtype=torch.int32)
        nm = torch.zeros((na, W), dtype=torch.int32)
        eb = torch.zeros((nb, 4, W), dtype=torch.int32)
        nmb = torch.zeros((nb, W), dtype=torch.int32)
        bit = int(np.uint32(1 << b).view(np.int32))
        other = int(np.uint32(1 << (b ^ 1)).view(np.int32))
        j2 = c0 + (j + 1) % T
        if x < 4:
            ea[r0 + i, x, w], eb[c0 + j, x, w], eb[j2, x, w] = bit, bit, other
        else:
            nm[r0 + i, w], nmb[c0 + j, w], nmb[j2, w] = bit, bit, other
        g, gn = kernels.split_gram(
            *(t.to(cuda_device) for t in (ea, nm)), r0, T, c0,
            *(t.to(cuda_device) for t in (eb, nmb)))
        want_g = torch.zeros((T, T), dtype=torch.int32)
        want_gn = torch.zeros((T, T), dtype=torch.int32)
        if x < 4:
            want_g[i, j] = 1
        else:
            want_g[i, j], want_gn[i, j] = -1, 1
        assert torch.equal(g.cpu(), want_g) and torch.equal(gn.cpu(), want_gn), (p, i, j, x)


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb,W,r0,rb,c0", [(300, None, 1000, 100, 130, 64),
                                               (150, 260, 2052, 0, 150, 3)])
def test_split_gram_cuda_word_splits_are_bit_identical(cuda_device, monkeypatch, na, nb, W, r0,
                                                       rb, c0):
    """Narrow blocks cut the word axis into parts that add their sums with
    integer atomics: whatever the number of parts (forced here; 0 is the
    launcher's own choice) and however often it is run, the tensors are the
    same and equal the plain version."""
    words = _cuda_words(cuda_device, na + W)
    ea, nm = words(na, 4, W), words(na, W)
    eb, nmb = (None, None) if nb is None else (words(nb, 4, W), words(nb, W))
    want = kernels.split_gram_reference(ea, nm, r0, rb, c0, eb, nmb)
    for splits in (0, 1, 2, 3, 7, 7, 10**6):
        monkeypatch.setattr(kernels, "_SPLIT_GRAM_WORD_SPLITS", splits)
        got = kernels.split_gram(ea, nm, r0, rb, c0, eb, nmb)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), splits
