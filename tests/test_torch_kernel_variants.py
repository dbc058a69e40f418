"""The port's tensor-core split-gram variants (``split_gram_variant``,
tracs_tpu_torch/ops/kernels.py) against the JAX package's experiment kernels
``scripts/kernel_experiments.py::make_kernel``, run in TPU interpret mode on
the CPU.  The same numpy-seeded layouts go through both; tolerance 0, every
output is an integer.  Also pins the ``torch.mm`` behaviours the plain
versions are built around, runs the experiments entry point at a small size,
and checks each CUDA variant against its plain version where a card exists."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from tracs_tpu_torch.experiments import kernel_experiments as port_experiments
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.runtime import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = kernels.SPLIT_GRAM_VARIANTS
VARIANT_IDS = [kernels.variant_name(*v) for v in VARIANTS]

#: name, A rows, B rows (None: self), W, r0, rb, c0
SHAPES = [
    ("square", 64, None, 16, 0, 64, 0),
    ("rectangle", 48, 14, 24, 5, 37, 3),
    ("ragged", 37, None, 17, 4, 30, 9),
]


def _layout(rng, n, W):
    """Random [n, 4, W] planes and [n, W] mask, uint32."""
    return (rng.integers(0, 2**32, size=(n, 4, W), dtype=np.uint32),
            rng.integers(0, 2**32, size=(n, W), dtype=np.uint32))


def _words(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _pad(a, rows, words):
    out = np.zeros((rows,) + a.shape[1:-1] + (words,), dtype=a.dtype)
    out[: a.shape[0], ..., : a.shape[-1]] = a
    return out


@pytest.fixture(scope="module")
def make_kernel():
    """``make_kernel`` of scripts/kernel_experiments.py, imported by path."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_experiments", os.path.join(REPO, "scripts", "kernel_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_kernel


def _jax_grams(make_kernel, dtype_name, layout, ea, nm, eb, nmb):
    """(g, gn) of the full A x B rectangle from the JAX kernel at tiles
    (128, 128, 16) in interpret mode; operands are zero-padded to whole
    tiles, which adds nothing to either gram."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    ti = tj = 128
    wc = 16
    na, nb, W = ea.shape[0], eb.shape[0], ea.shape[2]
    Wp = -(-W // wc) * wc
    pa, pb = -(-na // ti) * ti, -(-nb // tj) * tj
    call, prep = make_kernel(ti, tj, wc, dtype=getattr(jnp, dtype_name), layout=layout)
    with pltpu.force_tpu_interpret_mode():
        ka, kn = prep(jnp.asarray(_pad(ea, pa, Wp)), jnp.asarray(_pad(nm, pa, Wp)))
        kb, knb = prep(jnp.asarray(_pad(eb, pb, Wp)), jnp.asarray(_pad(nmb, pb, Wp)))
        g, gn = call(ka, kn, kb, knb)
    return np.asarray(g)[:na, :nb], np.asarray(gn)[:na, :nb]


#: the JAX kernel axes each port variant is held against: b1 has no TPU twin
#: (it is the dot on the packed layout) and is held against the int8 kernel
JAX_AXES = {"b1": ("int8", "u32"), "s8-shift": ("int8", "u32"),
            "s8-nibble": ("int8", "u8"), "bf16": ("bfloat16", "u32")}


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_variant_matches_make_kernel(make_kernel, variant, shape):
    dot, tile, unpack = variant
    _name, na, nb, W, r0, rb, c0 = shape
    rng = np.random.default_rng(na * 100 + W)
    ea, nm = _layout(rng, na, W)
    eb, nmb = (ea, nm) if nb is None else _layout(rng, nb, W)
    axes = JAX_AXES[f"{dot}-{unpack}" if unpack else dot]
    gj, gnj = _jax_grams(make_kernel, *axes, ea, nm, eb, nmb)
    b_args = (None, None) if nb is None else (_words(eb), _words(nmb))
    got = kernels.split_gram_variant(_words(ea), _words(nm), r0, rb, c0, *b_args,
                                     dot=dot, tile=tile, unpack=unpack)
    plain = kernels.split_gram_variant_reference(_words(ea), _words(nm), r0, rb, c0, *b_args,
                                                 dot=dot)
    for g, gn in (got, plain):
        assert g.dtype == gn.dtype == torch.int32 and g.shape == (rb, eb.shape[0] - c0)
        assert np.array_equal(g.numpy(), gj[r0:r0 + rb, c0:])
        assert np.array_equal(gn.numpy(), gnj[r0:r0 + rb, c0:])


@pytest.mark.parametrize("dot", ["b1", "s8", "bf16"])
def test_variant_reference_equals_split_gram_reference(dot):
    """Each variant's plain version equals K1's plain version, partial IUPAC
    codes (up to 3 bits a site in the exclusive planes) included."""
    from tracs_tpu_torch.ops.packing import pack_sequences, split_alignment
    from tracs_tpu_torch.ops.pairsnp import _split_device

    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(np.array(list("ACGTMRWSYKVHDBN-")), size=700)) for _ in range(21)]
    ea, nm = _split_device(split_alignment(pack_sequences(seqs)), torch.device("cpu"))[:2]
    want = kernels.split_gram_reference(ea, nm, 2, 17, 3)
    got = kernels.split_gram_variant_reference(ea, nm, 2, 17, 3, dot=dot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("W", [1, 3, 4, 5, 17])
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_variant_on_padded_layout_matches_unpadded(variant, W):
    """Zero words up to the card's pitch add nothing to any variant's grams,
    which equal K1's on the unpadded layout."""
    dot, tile, unpack = variant
    rng = np.random.default_rng(17 * W)
    a = tuple(_words(x) for x in _layout(rng, 13, W))
    b = tuple(_words(x) for x in _layout(rng, 9, W))
    want = kernels.split_gram(*a, 2, 10, 1, *b)
    pa, pb = kernels.pad_layout(*a), kernels.pad_layout(*b)
    assert pa[0].shape[2] == kernels.padded_words(W)
    got = kernels.split_gram_variant(*pa, 2, 10, 1, *pb, dot=dot, tile=tile, unpack=unpack)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("dot", ["s8", "bf16"])
def test_variant_reference_chunking_is_exact(monkeypatch, dot):
    """One-word chunks, and for bf16 a flush every word, give the same grams
    as one chunk."""
    rng = np.random.default_rng(8)
    ea, nm = (_words(x) for x in _layout(rng, 19, 11))
    want = kernels.split_gram_variant_reference(ea, nm, 1, 15, 2, dot=dot)
    monkeypatch.setattr(kernels, "_REFERENCE_BYTES", 1)
    monkeypatch.setattr(kernels, "_BF16_FLUSH_WORDS", 1)
    got = kernels.split_gram_variant_reference(ea, nm, 1, 15, 2, dot=dot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_flush_bound_keeps_f32_exact():
    """3 per site (a 3-bit code on both sides) over one flush interval stays
    below 2^24, where float32 stops holding every integer."""
    assert 3 * 32 * kernels._BF16_FLUSH_WORDS < 2**24
    assert float(torch.tensor(2.0**24, dtype=torch.float32) + 1) == 2.0**24


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_variant_cpu_call_counts_no_launch(variant):
    dot, tile, unpack = variant
    rng = np.random.default_rng(3)
    ea, nm = (_words(x) for x in _layout(rng, 5, 2))
    before = dict(profiling.counters)
    kernels.split_gram_variant(ea, nm, 0, 5, 0, dot=dot, tile=tile, unpack=unpack)
    assert profiling.counters == before
    assert kernels.variant_name(dot, tile, unpack) in {kernels.variant_name(*v)
                                                       for v in kernels.SPLIT_GRAM_VARIANTS}


@pytest.mark.parametrize(
    "kwargs", [dict(dot="b1", tile=32), dict(dot="int4", tile=64), dict(dot="s8", tile=64),
               dict(dot="b1", tile=64, unpack="shift"), dict(dot="s8", tile=128, unpack="prmt")])
def test_variant_rejects_unbuilt_combinations(kwargs):
    ea = torch.zeros((6, 4, 3), dtype=torch.int32)
    nm = torch.zeros((6, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.split_gram_variant(ea, nm, 0, 6, 0, **kwargs)


@pytest.mark.parametrize("case", ["int64", "rows", "cols", "eb_alone", "noncontig"])
def test_variant_rejects_bad_inputs(case):
    """The same operand checks as split_gram."""
    ea = torch.zeros((6, 4, 3), dtype=torch.int32)
    nm = torch.zeros((6, 3), dtype=torch.int32)
    args = dict(ea=ea, nm=nm, r0=0, rb=6, c0=0, eb=None, nmb=None)
    if case == "int64":
        args["ea"] = ea.long()
    elif case == "rows":
        args["r0"] = 2
    elif case == "cols":
        args["c0"] = 7
    elif case == "eb_alone":
        args["eb"] = ea
    elif case == "noncontig":
        args["ea"] = torch.zeros((6, 4, 6), dtype=torch.int32)[:, :, ::2]
    with pytest.raises((TypeError, ValueError)):
        kernels.split_gram_variant(**args, dot="s8", tile=128)


# -- torch behaviours the plain versions are built around --

def test_trap_bf16_mm_is_not_exact_above_256():
    """A bf16 torch.mm returns bf16, whose 8-bit mantissa holds every integer
    only up to 256 (above it only every second one): 301 ones do not sum to
    301.  The bf16 plain version widens its bf16 operands to float32 and
    contracts there."""
    ones = torch.ones((1, 301), dtype=torch.bfloat16)
    out = torch.mm(ones, ones.T)
    assert out.dtype == torch.bfloat16 and float(out) != 301.0
    assert float(ones.float() @ ones.float().T) == 301.0
    bits = torch.full((1, 4, 10), -1, dtype=torch.int32)  # 320 set bits per plane
    g, gn = kernels.split_gram_variant_reference(bits, bits[:, 0].contiguous(), 0, 1, 0,
                                                 dot="bf16")
    assert int(gn) == 320 and int(g) == 4 * 320 - 320


def test_trap_int8_mm_wraps_in_the_s8_plain_version():
    """int8 torch.mm wraps at 128; the s8 plain version widens its int8
    operands to int32 before the contraction."""
    ones = torch.ones((1, 200), dtype=torch.int8)
    assert int(torch.mm(ones, ones.T)) == 200 - 256
    bits = torch.full((1, 4, 7), -1, dtype=torch.int32)  # 224 set bits per plane
    g, gn = kernels.split_gram_variant_reference(bits, bits[:, 0].contiguous(), 0, 1, 0,
                                                 dot="s8")
    assert int(gn) == 224 and int(g) == 4 * 224 - 224


# -- the experiments entry point --

def test_experiments_entry_point_on_cpu(capsys):
    rows = port_experiments.main(["12", "2000", "--device", "cpu"])
    assert [r["name"] for r in rows] == ["split_gram"] + VARIANT_IDS
    assert rows[0]["ok"] is None and all(r["ok"] is True for r in rows[1:])
    out = capsys.readouterr().out
    assert out.count("[OK]") == len(VARIANTS) and "[ref]" in out and "MISMATCH" not in out


def test_experiments_entry_point_exits_nonzero_on_mismatch(monkeypatch):
    real = kernels.split_gram_variant

    def broken(*args, **kwargs):
        g, gn = real(*args, **kwargs)
        return (g + 1, gn) if kwargs["dot"] == "bf16" else (g, gn)

    monkeypatch.setattr(kernels, "split_gram_variant", broken)
    with pytest.raises(SystemExit) as exc:
        port_experiments.main(["6", "500", "--device", "cpu"])
    assert exc.value.code not in (0, None) and "bf16-128" in str(exc.value.code)


def test_experiments_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from tracs_tpu_torch.runtime.device import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        port_experiments.main(["6", "500"])


def test_workload_matches_bench():
    """The package's workload generator is bench.py's make_clustered, array
    for array."""
    import sys

    pytest.importorskip("jax")
    sys.path.insert(0, REPO)
    import bench

    from tracs_tpu_torch.experiments.workload import make_clustered

    got = make_clustered(40, 3000)
    want = bench.make_clustered(40, 3000)
    assert np.array_equal(got.planes, want.planes) and got.names == want.names


# -- on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "na,nb,W,r0,rb,c0",
    [(37, None, 17, 0, 37, 0), (48, 14, 17, 5, 37, 3), (300, None, 1000, 100, 130, 64),
     (700, None, 301, 0, 300, 60)],   # 3 x 5 tiles of 128: clusters with blocks past the edge
)
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_variant_cuda_matches_plain(cuda_device, variant, na, nb, W, r0, rb, c0):
    dot, tile, unpack = variant
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(na * W)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=cuda_device, generator=gen)

    ea, nm = kernels.pad_layout(words(na, 4, W), words(na, W))
    eb, nmb = (None, None) if nb is None else kernels.pad_layout(words(nb, 4, W), words(nb, W))
    name = kernels.variant_name(dot, tile, unpack)
    before = profiling.counter("kernel.launches.split_gram_mma." + name)
    g, gn = kernels.split_gram_variant(ea, nm, r0, rb, c0, eb, nmb, dot=dot, tile=tile,
                                       unpack=unpack)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.launches.split_gram_mma." + name) == before + 1
    g0, gn0 = kernels.split_gram_variant_reference(ea, nm, r0, rb, c0, eb, nmb, dot=dot)
    assert torch.equal(g, g0) and torch.equal(gn, gn0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_variant_cuda_single_bit_walk(cuda_device, variant):
    """The smallest check of the ``mma`` fragment layouts: one 16 x 8 output
    tile over 16 words, one set bit on each side walked through every word,
    bit, plane, row and column.  A bit that a lane files under the wrong row,
    column or k slot lands in another output or meets no partner."""
    dot, tile, unpack = variant
    W = 16
    for p in range(W * 32):
        w, b = divmod(p, 32)
        i, j, x = p % 16, (3 * p) % 8, p % 5   # plane 4 is the N mask
        ea = torch.zeros((16, 4, W), dtype=torch.int32)
        nm = torch.zeros((16, W), dtype=torch.int32)
        eb = torch.zeros((8, 4, W), dtype=torch.int32)
        nmb = torch.zeros((8, W), dtype=torch.int32)
        bit = int(np.uint32(1 << b).view(np.int32))
        other = int(np.uint32(1 << (b ^ 1)).view(np.int32))
        if x < 4:
            ea[i, x, w], eb[j, x, w], eb[(j + 1) % 8, x, w] = bit, bit, other
        else:
            nm[i, w], nmb[j, w], nmb[(j + 1) % 8, w] = bit, bit, other
        g, gn = kernels.split_gram_variant(
            *(t.to(cuda_device) for t in (ea, nm)), 0, 16, 0,
            *(t.to(cuda_device) for t in (eb, nmb)), dot=dot, tile=tile, unpack=unpack)
        want_g = torch.zeros((16, 8), dtype=torch.int32)
        want_gn = torch.zeros((16, 8), dtype=torch.int32)
        if x < 4:
            want_g[i, j] = 1
        else:
            want_g[i, j], want_gn[i, j] = -1, 1
        assert torch.equal(g.cpu(), want_g) and torch.equal(gn.cpu(), want_gn), (p, i, j, x)


@pytest.mark.cuda
@pytest.mark.parametrize("r0,c0", [(0, 0), (70, 130)])
def test_b1_128_cuda_single_bit_walk_over_a_whole_tile(cuda_device, r0, c0):
    """The ``wgmma`` variant's shared-memory descriptor layout and accumulator
    fragment: one set bit on each side walked through every word and bit of a
    16-word chunk (both k256 steps, all four 16-byte pieces) and every row and
    column of a whole 128 x 128 tile (both warpgroups, every core matrix),
    through all five planes."""
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
        g, gn = kernels.split_gram_variant(
            *(t.to(cuda_device) for t in (ea, nm)), r0, T, c0,
            *(t.to(cuda_device) for t in (eb, nmb)), dot="b1", tile=128)
        want_g = torch.zeros((T, T), dtype=torch.int32)
        want_gn = torch.zeros((T, T), dtype=torch.int32)
        if x < 4:
            want_g[i, j] = 1
        else:
            want_g[i, j], want_gn[i, j] = -1, 1
        assert torch.equal(g.cpu(), want_g) and torch.equal(gn.cpu(), want_gn), (p, i, j, x)


@pytest.mark.cuda
@pytest.mark.parametrize("flush_words", [16, 48, 400])
def test_bf16_cuda_flushes_exactly(cuda_device, monkeypatch, flush_words):
    """The bf16 kernel's add-to-output flush, forced every few chunks."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(flush_words)
    ea = torch.randint(-2**31, 2**31, (150, 4, 1000), dtype=torch.int32,
                       device=cuda_device, generator=gen)
    nm = torch.randint(-2**31, 2**31, (150, 1000), dtype=torch.int32,
                       device=cuda_device, generator=gen)
    monkeypatch.setattr(kernels, "_BF16_FLUSH_WORDS", flush_words)
    g, gn = kernels.split_gram_variant(ea, nm, 3, 140, 7, dot="bf16", tile=128)
    torch.cuda.synchronize()
    g0, gn0 = kernels.split_gram_reference(ea, nm, 3, 140, 7)
    assert torch.equal(g, g0) and torch.equal(gn, gn0)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [4, 20, 36])
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_variant_cuda_words_end_inside_a_chunk(cuda_device, variant, W):
    """Word counts that end after the first 16-byte piece of a 16-word chunk
    (the pieces past them are copied as zeros), on layouts padded from W - 1
    words so that the last staged word is a pad word."""
    dot, tile, unpack = variant
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(W)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=cuda_device, generator=gen)

    ea, nm = kernels.pad_layout(words(140, 4, W - 1), words(140, W - 1))
    assert ea.shape[2] == W
    g, gn = kernels.split_gram_variant(ea, nm, 3, 131, 5, dot=dot, tile=tile, unpack=unpack)
    torch.cuda.synchronize()
    g0, gn0 = kernels.split_gram_variant_reference(ea, nm, 3, 131, 5, dot=dot)
    assert torch.equal(g, g0) and torch.equal(gn, gn0)
