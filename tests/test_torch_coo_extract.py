"""The port's block extraction (ops/kernels.py ``coo_extract``: the D/NN
assembly, threshold, triangle mask and row-major COO compaction of one block)
against the JAX package's ``_assemble_d`` / ``_assemble_nn`` /
``_assemble_popcount`` followed by ``_extract_coo_packed`` (capacity = the
whole block) and ``_unpack_survivors``, on the same numpy-seeded grams.
Tolerance 0: every output is an integer, and the pairs come in the same
row-major order.  The JAX function compares D with the threshold it is given;
the port clamps it to [-1, 2^31 - 1] first, so the JAX side is handed the
clamped value (D is never negative, so a threshold below -1 keeps what -1
keeps: nothing).  The CUDA kernel is held against its plain version where a
card exists.

jax is imported inside the tests that need it, so the card-only tests run on
a machine without it."""

import numpy as np
import pytest
import torch

from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops.packing import from_reference
from tracs_tpu_torch.runtime import profiling

INT32_MAX = 2**31 - 1
DISTS = [-5, -1, 0, 40, INT32_MAX, 10**12]
#: (name, rb, m, r0, c0, n_valid, triangle): the sweep's triangle blocks (the
#: column suffix c0 = r0, and a ring stripe's c0 = 0 below r0), a rectangle,
#: and slabs whose last columns lie past n_valid (the mesh's padding)
GEOMETRIES = [
    ("triangle suffix", 9, 14, 5, 5, 19, True),
    ("triangle from row 0", 14, 14, 0, 0, 14, True),
    ("triangle stripe c0 < r0", 6, 20, 7, 0, 20, True),
    ("rectangle", 9, 14, 7, 0, 14, False),
    ("slab past n_valid", 9, 14, 3, 6, 16, False),
    ("triangle slab past n_valid", 9, 14, 2, 6, 17, True),
]
#: (mode, with the correction gram)
VARIANTS = [("split", True), ("split", False), ("direct", False)]
L = 500


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tracs_tpu.ops import pairsnp as jref

    return jnp, jref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _grams(rng, rb, m, mode, with_gp, dmax=80):
    """numpy int32 grams of a block whose D lies in [0, dmax): for ``split``
    g, gn, gp (or None), cnt_a, cnt_b; for ``direct`` matches and nunion."""
    D = rng.integers(0, dmax, size=(rb, m), dtype=np.int32)
    if mode == "direct":
        nunion = rng.integers(0, L, size=(rb, m), dtype=np.int32)
        return {"mode": "direct", "g": (L - D).astype(np.int32), "gn": nunion}
    cnt_a = rng.integers(0, 10, size=rb, dtype=np.int32)
    cnt_b = rng.integers(0, 10, size=m, dtype=np.int32)
    gp = rng.integers(-20, 1, size=(rb, m), dtype=np.int32) if with_gp else None
    g = L - D - cnt_a[:, None] - cnt_b[None, :] - (0 if gp is None else gp)
    gn = rng.integers(0, L - 20, size=(rb, m), dtype=np.int32)
    return {"mode": "split", "g": g.astype(np.int32), "gn": gn, "gp": gp,
            "cnt_a": cnt_a, "cnt_b": cnt_b}


def _torch(grams, device="cpu"):
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
            for k, v in grams.items()}


def _jax_blocks(jax_ref, grams):
    """(D, NN) by tracs_tpu's assembly functions."""
    jnp, jref = jax_ref
    L32 = jnp.int32(L)
    if grams["mode"] == "direct":
        return jref._assemble_popcount(jnp.asarray(grams["g"]), jnp.asarray(grams["gn"]), L32)
    gp = jnp.zeros((), jnp.int32) if grams["gp"] is None else jnp.asarray(grams["gp"])
    cnt_a, cnt_b = jnp.asarray(grams["cnt_a"]), jnp.asarray(grams["cnt_b"])
    return (jref._assemble_d(jnp.asarray(grams["g"]), gp, cnt_a, cnt_b, L32),
            jref._assemble_nn(jnp.asarray(grams["gn"]), cnt_a, cnt_b, L32))


def _jax_coo(jax_ref, grams, dist, r0, c0, n_valid, triangle):
    """(rows_local, cols_global, d, nn) by ``_extract_coo_packed`` at the
    capacity of the whole block, then ``_unpack_survivors``."""
    jnp, jref = jax_ref
    D, NN = _jax_blocks(jax_ref, grams)
    rb, m = D.shape
    packed = np.asarray(jref._extract_coo_packed(
        D, NN, kernels.clamp_threshold(dist), jnp.int32(r0), jnp.int32(n_valid),
        jnp.int32(c0), capacity=rb * m, triangle=triangle))
    return jref._unpack_survivors(packed, rb * m, int(packed[0]), m, c0)


def _assert_coo_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        assert np.array_equal(g, np.asarray(w, dtype=np.int64))


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
@pytest.mark.parametrize("mode,with_gp", VARIANTS, ids=["split+gp", "split", "direct"])
def test_coo_extract_matches_reference(jax_ref, mode, with_gp, geometry, dist):
    _, rb, m, r0, c0, n_valid, triangle = geometry
    rng = np.random.default_rng([rb, m, r0, c0, int(with_gp), len(mode)])
    grams = _grams(rng, rb, m, mode, with_gp)
    want = _jax_coo(jax_ref, grams, dist, r0, c0, n_valid, triangle)
    coo = kernels.coo_extract(**_torch(grams), L=L, dist=dist, r0=r0, c0=c0, n_valid=n_valid,
                              triangle=triangle)
    assert coo.dtype == torch.int32 and coo.shape == (4, len(want[0]))
    got = port._extract_coo(_torch(grams), L, dist, r0, n_valid, c0, triangle=triangle)
    _assert_coo_equal(got, want)
    if dist < 0:
        assert len(got[0]) == 0
    if dist >= INT32_MAX:  # every pair inside the masks survives
        cols = np.arange(m) + c0
        keep = (cols < n_valid)[None, :] & np.ones((rb, 1), dtype=bool)
        if triangle:
            keep &= cols[None, :] > (np.arange(rb) + r0)[:, None]
        assert len(got[0]) == int(keep.sum()) > 0


@pytest.mark.parametrize("mode,with_gp", VARIANTS, ids=["split+gp", "split", "direct"])
@pytest.mark.parametrize("dist,survives", [(INT32_MAX, True), (-1, False), (0, None)])
def test_one_by_one_block(jax_ref, mode, with_gp, dist, survives):
    rng = np.random.default_rng(len(mode) + int(with_gp))
    grams = _grams(rng, 1, 1, mode, with_gp, dmax=1)  # D = 0
    want = _jax_coo(jax_ref, grams, dist, 3, 4, 5, True)
    got = port._extract_coo(_torch(grams), L, dist, 3, 5, 4, triangle=True)
    _assert_coo_equal(got, want)
    assert len(got[0]) == (0 if survives is False else 1)
    assert list(got[1]) == ([] if survives is False else [4])


@pytest.mark.parametrize("rb,m", [(0, 7), (6, 0), (0, 0)])
@pytest.mark.parametrize("mode", ["split", "direct"])
def test_empty_block(mode, rb, m):
    """An empty block keeps no pair (tracs_tpu's host twin
    ``_host_block_sparse`` agrees; its device function needs a non-empty
    block)."""
    from tracs_tpu.ops import pairsnp as jref

    grams = _grams(np.random.default_rng(0), rb, m, mode, True)
    coo = kernels.coo_extract(**_torch(grams), L=L, dist=INT32_MAX, r0=0, c0=0, n_valid=m,
                              triangle=False)
    assert coo.dtype == torch.int32 and coo.shape == (4, 0)
    D = np.zeros((rb, m), dtype=np.int32)
    want = jref._host_block_sparse(D, D, INT32_MAX, 0, m, triangle=False)
    _assert_coo_equal(port._extract_coo(_torch(grams), L, INT32_MAX, 0, m, 0, triangle=False),
                      want)


def test_no_survivor_block(jax_ref):
    """D far above the threshold everywhere: nothing, on both sides."""
    grams = _grams(np.random.default_rng(3), 9, 14, "split", True)
    grams["g"] = (grams["g"] - 400).astype(np.int32)  # D >= 400
    want = _jax_coo(jax_ref, grams, 399, 0, 0, 14, False)
    got = port._extract_coo(_torch(grams), L, 399, 0, 14, 0, triangle=False)
    assert len(want[0]) == 0
    _assert_coo_equal(got, want)


def test_wrapped_int32_arithmetic_matches_reference(jax_ref):
    """Grams near the int32 limits: the assembly wraps as XLA's int32 does."""
    rng = np.random.default_rng(11)
    grams = _grams(rng, 5, 8, "split", True)
    grams["g"] = rng.integers(-2**31, 2**31, size=(5, 8), dtype=np.int64).astype(np.int32)
    grams["gn"] = rng.integers(-2**31, 2**31, size=(5, 8), dtype=np.int64).astype(np.int32)
    for dist in (0, 2**30, INT32_MAX):
        want = _jax_coo(jax_ref, grams, dist, 0, 0, 8, False)
        got = port._extract_coo(_torch(grams), L, dist, 0, 8, 0, triangle=False)
        _assert_coo_equal(got, want)


@pytest.mark.parametrize("method", ["split", "popcount", "mxu"])
@pytest.mark.parametrize("dist", [-1, 0, 3, INT32_MAX])
@pytest.mark.parametrize("two", [False, True], ids=["triangle", "rectangle"])
def test_stream_through_coo_extract_matches_reference(jax_ref, method, dist, two):
    """The slice as a whole: every engine's blocks through ``coo_extract``
    yield what tracs_tpu's stream yields, array for array."""
    from tracs_tpu.ops import packing as jpacking
    from tracs_tpu.ops import pairsnp as jref

    rng = np.random.default_rng(len(method) + dist % 97)
    alphabet = np.array(list("ACGTMRWSYKVHDBN-"))
    seqs = ["".join(rng.choice(alphabet, size=150)) for _ in range(23)]
    base = rng.choice(np.array(list("ACGT")), size=150)
    seqs[3:9] = ["".join(np.where(rng.random(150) < 0.02, "N", base)) for _ in range(6)]
    ja = jpacking.pack_sequences(seqs[:15])
    jb = jpacking.pack_sequences(seqs[15:])
    pa = from_reference(ja.planes, ja.length, ja.names)
    pb = from_reference(jb.planes, jb.length, jb.names)
    fasta_j, fasta_p = ([ja, jb], [pa, pb]) if two else ([ja], [pa])
    want = list(jref.pairsnp_stream(fasta_j, dist=kernels.clamp_threshold(dist),
                                    method=method, row_block=4))
    before = profiling.counter("kernel.launches.coo_extract")
    got = list(port.pairsnp_stream(fasta_p, dist=dist, device="cpu", method=method,
                                   row_block=4))
    assert profiling.counter("kernel.launches.coo_extract") == before  # the CPU counts no launch
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for k in range(3, 8):
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


#: capacity geometries beyond GEOMETRIES: (name, rb, m, r0, c0, n_valid, triangle)
CAPACITY_EXTRA = [
    ("1 x 1", 1, 1, 3, 4, 5, True),
    ("1 x 1 below the diagonal", 1, 1, 4, 4, 5, True),
    ("no row", 0, 7, 0, 0, 7, True),
    ("no column", 6, 0, 2, 2, 9, False),
    ("every column past n_valid", 5, 8, 0, 10, 9, False),
]


@pytest.mark.parametrize("geometry", GEOMETRIES + CAPACITY_EXTRA,
                         ids=[g[0] for g in GEOMETRIES + CAPACITY_EXTRA])
def test_capacity_counts_every_pair_in_range(jax_ref, geometry):
    """The wrapper's output size, arithmetic on the block's geometry, is the
    number of pairs tracs_tpu keeps at a threshold of 2^31 - 1: the card's
    output is exactly filled there."""
    _, rb, m, r0, c0, n_valid, triangle = geometry
    cap = kernels.coo_capacity(rb, m, r0, c0, n_valid, triangle)
    grams = _grams(np.random.default_rng([rb, m, r0]), rb, m, "split", True)
    got = port._extract_coo(_torch(grams), L, INT32_MAX, r0, n_valid, c0, triangle=triangle)
    assert len(got[0]) == cap
    if rb and m:
        want = _jax_coo(jax_ref, grams, INT32_MAX, r0, c0, n_valid, triangle)
        assert len(want[0]) == cap
    else:
        assert cap == 0


def test_capacity_arithmetic_over_small_geometries():
    """``coo_capacity`` against a row-by-row count of the two masks on every
    small geometry: r0 above, at and below c0, n_valid inside, at and past
    the block, triangle or not."""
    for rb in range(0, 6):
        for m in range(0, 6):
            for r0 in range(0, 8):
                for c0 in range(0, 8):
                    for n_valid in range(0, 13):
                        cols = np.arange(m) + c0
                        keep = np.broadcast_to((cols < n_valid)[None, :], (rb, m))
                        for triangle in (False, True):
                            k = keep & (cols[None, :] > (np.arange(rb) + r0)[:, None]) \
                                if triangle else keep
                            assert kernels.coo_capacity(rb, m, r0, c0, n_valid, triangle) \
                                == int(k.sum()), (rb, m, r0, c0, n_valid, triangle)


def test_refusals():
    grams = _torch(_grams(np.random.default_rng(5), 4, 6, "split", True))
    kw = dict(L=L, dist=10, r0=0, c0=0, n_valid=6, triangle=True)
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.coo_extract(**{**grams, "mode": "dense"}, **kw)
    with pytest.raises(TypeError, match="int32"):
        kernels.coo_extract(**{**grams, "g": grams["g"].long()}, **kw)
    with pytest.raises(ValueError, match="gn is"):
        kernels.coo_extract(**{**grams, "gn": grams["gn"][:, :5].contiguous()}, **kw)
    with pytest.raises(ValueError, match="cnt_b"):
        kernels.coo_extract(**{**grams, "cnt_b": grams["cnt_b"][:5]}, **kw)
    with pytest.raises(ValueError, match="needs cnt_a"):
        kernels.coo_extract(**{**grams, "cnt_a": None}, **kw)
    with pytest.raises(ValueError, match="direct mode"):
        kernels.coo_extract(**{**grams, "mode": "direct"}, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.coo_extract(**{**grams, "gp": grams["gp"].T.contiguous().T}, **kw)
    with pytest.raises(ValueError, match="length"):
        kernels.coo_extract(**grams, **{**kw, "L": 2**31})
    with pytest.raises(ValueError, match=">= 0"):
        kernels.coo_extract(**grams, **{**kw, "c0": -1})


@pytest.mark.parametrize("triangle", [False, True], ids=["rectangle", "triangle"])
@pytest.mark.parametrize("mode,with_gp", VARIANTS, ids=["split+gp", "split", "direct"])
def test_a_launched_extraction_is_coo_extract(mode, with_gp, triangle):
    """``coo_extract_launch`` gives ``coo_extract``'s [4, k] through ``wait()``
    and its [k, 4] transpose through ``host()``; ``_extract_coo`` takes a
    launch that a block's grams carry under ``coo`` as it would launch one."""
    grams = _torch(_grams(np.random.default_rng([7, int(with_gp), len(mode)]), 9, 14, mode,
                          with_gp))
    kw = dict(L=L, dist=40, r0=3, c0=3, n_valid=16, triangle=triangle)
    want = kernels.coo_extract(**grams, **kw)
    pending = kernels.coo_extract_launch(**grams, **kw)
    assert torch.equal(pending.wait(), want)
    host = pending.host()
    assert host.dtype == np.int32 and np.array_equal(host, want.T.numpy())
    fresh = port._extract_coo(grams, L, 40, 3, 16, 3, triangle=triangle)
    carried = port._extract_coo({**grams, "coo": kernels.coo_extract_launch(**grams, **kw)},
                                L, 40, 3, 16, 3, triangle=triangle)
    _assert_coo_equal(carried, fresh)


def test_a_device_without_a_kernel_raises():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on the
    ``meta`` device gets no plain version."""
    grams = _torch(_grams(np.random.default_rng(6), 3, 4, "direct", False), device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        kernels.coo_extract(**grams, L=L, dist=10, r0=0, c0=0, n_valid=4, triangle=False)


# -- on the card --

@pytest.mark.cuda
@pytest.mark.parametrize("dist", [-1, 0, 200, INT32_MAX])
@pytest.mark.parametrize("mode,with_gp", VARIANTS, ids=["split+gp", "split", "direct"])
@pytest.mark.parametrize("rb,m,r0,c0,n_valid,triangle", [
    (1, 1, 0, 0, 1, False),
    (37, 2500, 100, 100, 2600, True),   # rows of three segments, the diagonal inside
    (64, 3000, 40, 0, 2990, True),      # a stripe: c0 = 0 below r0, padded columns
    (50, 1024, 0, 2048, 2500, False),   # a slab past n_valid
    (300, 33, 7, 0, 33, False),
])
def test_coo_extract_cuda_matches_plain(cuda_device, mode, with_gp, dist, rb, m, r0, c0,
                                        n_valid, triangle):
    rng = np.random.default_rng([rb, m, int(with_gp), len(mode)])
    grams = _torch(_grams(rng, rb, m, mode, with_gp, dmax=2000), device=cuda_device)
    kw = dict(L=L, dist=dist, r0=r0, c0=c0, n_valid=n_valid, triangle=triangle)
    before = profiling.counter("kernel.launches.coo_extract")
    got = kernels.coo_extract(**grams, **kw)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.launches.coo_extract") == before + 1
    want = kernels.coo_extract_reference(**grams, **kw)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
def test_coo_extract_cuda_dense_block(cuda_device):
    """Every pair of a 700 x 5000 block survives: 3.5 M pairs, placed in
    row-major order across many segments and tiles of the scan."""
    grams = _torch(_grams(np.random.default_rng(1), 700, 5000, "split", True), cuda_device)
    kw = dict(L=L, dist=INT32_MAX, r0=0, c0=0, n_valid=5000, triangle=False)
    got = kernels.coo_extract(**grams, **kw)
    torch.cuda.synchronize()
    assert got.shape == (4, 700 * 5000)
    assert torch.equal(got, kernels.coo_extract_reference(**grams, **kw))


@pytest.mark.cuda
def test_stream_cuda_extracts_every_block(cuda_device):
    """One launch a row block of every engine, and the CPU's arrays."""
    from tracs_tpu_torch.ops.packing import pack_sequences

    rng = np.random.default_rng(14)
    alphabet = np.array(list("ACGTMRWSYKVHDBN-"))
    p = pack_sequences(["".join(rng.choice(alphabet, size=1000)) for _ in range(70)])
    want = list(port.pairsnp_stream([p], row_block=16, device="cpu", dist=700))
    for method in ("split", "popcount", "mxu"):
        before = profiling.counter("kernel.launches.coo_extract")
        got = list(port.pairsnp_stream([p], row_block=16, device=cuda_device, method=method,
                                       dist=700))
        assert profiling.counter("kernel.launches.coo_extract") == before + 5
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            assert all(np.array_equal(x, y) for x, y in zip(g[3:], w[3:]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,with_gp", VARIANTS, ids=["split+gp", "split", "direct"])
def test_coo_extract_cuda_fills_its_capacity(cuda_device, mode, with_gp):
    """The main path's first block, 1024 x 4096 triangle pairs, at a threshold
    of 2^31 - 1: every pair in range survives, so the 3,669,504 rows sized on
    the host are exactly filled, in row-major order."""
    grams = _torch(_grams(np.random.default_rng(21), 1024, 4096, mode, with_gp), cuda_device)
    kw = dict(L=L, dist=INT32_MAX, r0=0, c0=0, n_valid=4096, triangle=True)
    got = kernels.coo_extract(**grams, **kw)
    torch.cuda.synchronize()
    assert got.shape == (4, kernels.coo_capacity(1024, 4096, 0, 0, 4096, True)) == (4, 3669504)
    assert torch.equal(got, kernels.coo_extract_reference(**grams, **kw))


@pytest.mark.cuda
def test_coo_extract_cuda_look_back_crosses_waves(cuda_device):
    """A block of 2048 x 16384 pairs: 32,768 segments of 1024 columns, 4,096
    tiles of 8, more than the card holds at once, so tiles wait on tiles of
    an earlier wave of blocks."""
    grams = _torch(_grams(np.random.default_rng(22), 2048, 16384, "split", True, dmax=2000),
                   cuda_device)
    for dist, triangle in ((200, False), (1000, True)):
        kw = dict(L=L, dist=dist, r0=100, c0=0, n_valid=16000, triangle=triangle)
        got = kernels.coo_extract(**grams, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.coo_extract_reference(**grams, **kw))


@pytest.mark.cuda
def test_coo_extract_cuda_repeated_launches_agree(cuda_device):
    """20 launches on the same block give the same rows, whatever order the
    blocks took their tickets in; each is one launch."""
    grams = _torch(_grams(np.random.default_rng(23), 1024, 3072, "direct", False, dmax=3000),
                   cuda_device)
    kw = dict(L=L, dist=200, r0=1024, c0=1024, n_valid=4000, triangle=True)
    want = kernels.coo_extract_reference(**grams, **kw)
    before = profiling.counter("kernel.launches.coo_extract")
    for _ in range(20):
        got = kernels.coo_extract(**grams, **kw)
        assert torch.equal(got, want)
    assert profiling.counter("kernel.launches.coo_extract") == before + 20


@pytest.mark.cuda
def test_coo_extract_cuda_takes_a_block_while_the_next_is_queued(cuda_device):
    """The sweep's order: block A launched, then the larger block B, then A's
    survivors taken (their copy on the side stream waits for A alone), then
    B's.  Each equals its plain version."""
    rng = np.random.default_rng(24)
    a = _torch(_grams(rng, 1024, 3072, "split", True, dmax=2000), cuda_device)
    b = _torch(_grams(rng, 2048, 16384, "split", True, dmax=2000), cuda_device)
    kw_a = dict(L=L, dist=300, r0=1024, c0=1024, n_valid=4000, triangle=True)
    kw_b = dict(L=L, dist=200, r0=0, c0=0, n_valid=16000, triangle=True)
    pending_a = kernels.coo_extract_launch(**a, **kw_a)
    pending_b = kernels.coo_extract_launch(**b, **kw_b)
    got_a = pending_a.host()
    assert np.array_equal(got_a, kernels.coo_extract_reference(**a, **kw_a).T.cpu().numpy())
    got_b = pending_b.host()
    assert np.array_equal(got_b, kernels.coo_extract_reference(**b, **kw_b).T.cpu().numpy())
    assert len(got_a) and len(got_b)
