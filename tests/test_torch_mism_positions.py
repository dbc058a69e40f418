"""The tiled mismatch-position kernel of ops/kernels.py (csrc/mism_positions.cu):
its tile plan (csrc/mism_plan.cpp, built with g++ here as on the card's
host), the rule that picks it, the cut of the word axis, and a plain numpy
walk of its parts and offsets, on the CPU; on a card, the kernel itself held
exactly (tolerance 0: the output is integers) against
``mismatch_positions_reference``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_recomb import PAIR_PATTERNS, _pair_pattern, _word_tensors
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.runtime import profiling


def _clustered_pairs(n_clusters, size, start=0):
    """Row-major pairs i < j within clusters of consecutive samples: the
    sweep's COO of a clustered block."""
    ii, jj = [], []
    for c in range(n_clusters):
        b = start + c * size
        for i in range(b, b + size):
            ii += [i] * (b + size - i - 1)
            jj += list(range(i + 1, b + size))
    return np.array(ii), np.array(jj)


def _check_plan(plan, ii, jj, samples, one_layout=True):
    """Every pair in one tile, in the caller's order; no tile above its caps;
    the slots name the pair's own samples, sorted by side then row; each tile
    ends where the next pair would break a cap (the cut is greedy); the
    tile's copies cover its slots once, in order, each a box of 1, 2, 4 or 8
    samples on consecutive rows of one side."""
    ps, ks, keys, slots, bs, boxes = plan
    P, max_pairs = len(ii), kernels.MISM_TILE_PAIRS
    assert ps[0] == 0 and ps[-1] == P and (np.diff(ps) >= 1).all()
    assert ks[0] == 0 and ks[-1] == len(keys) and len(slots) == P
    want_b = jj if one_layout else ~jj
    for t in range(plan.tiles):
        a, b = ps[t], ps[t + 1]
        tk = keys[ks[t]:ks[t + 1]]
        assert len(set(tk.tolist())) == len(tk) <= samples and b - a <= max_pairs
        side_row = [(k < 0, ~k if k < 0 else k) for k in tk.tolist()]
        assert side_row == sorted(side_row)
        covered = 0
        for box in boxes[bs[t]:bs[t + 1]].tolist():
            first, rows = box & 0xFF, 1 << (box >> 8)
            assert first == covered and rows <= 8
            run = side_row[first:first + rows]
            assert run == [(run[0][0], run[0][1] + k) for k in range(rows)]
            covered += rows
        assert covered == len(tk)
        assert (tk[slots[a:b] & 0xFF] == ii[a:b]).all()
        assert (tk[slots[a:b] >> 8] == want_b[a:b]).all()
        if b < P:
            grown = set(tk.tolist()) | {int(ii[b]), int(want_b[b])}
            assert len(grown) > samples or b - a == max_pairs


@pytest.mark.parametrize("one_layout", [True, False])
@pytest.mark.parametrize("pattern", PAIR_PATTERNS)
def test_tile_plan_covers_every_pair_once_in_order(pattern, one_layout):
    rng = np.random.default_rng(50)
    ii, jj = _pair_pattern(pattern, rng, 12)
    for samples in (2, 4, 28):
        plan = kernels.mism_tile_plan(ii, jj, samples=samples, one_layout=one_layout)
        _check_plan(plan, ii, jj, samples, one_layout)


def test_tile_plan_cuts_runs_longer_than_a_tile():
    """A run of one first sample longer than a tile's pairs or samples is cut
    inside the run; a tile boundary falls inside a row of the clustered list."""
    ii, jj = np.full(1300, 5), np.arange(1300) % 7
    plan = kernels.mism_tile_plan(ii, jj)
    assert plan.tiles == 3 and plan.pair_start.tolist() == [0, 512, 1024, 1300]
    _check_plan(plan, ii, jj, 28)
    ii, jj = _clustered_pairs(3, 21)
    plan = kernels.mism_tile_plan(ii, jj, samples=8)
    _check_plan(plan, ii, jj, 8)
    row_starts = set(np.flatnonzero(np.diff(ii)) + 1)
    assert any(int(s) not in row_starts for s in plan.pair_start[1:-1])


def test_tile_plan_self_pairs_repeats_and_two_layouts():
    """A self pair on one layout stages its sample once (both slots equal);
    on two layouts row r of A and row r of B are two samples.  Repeated
    pairs reuse their slots."""
    ii = np.array([3, 3, 4, 3, 3])
    jj = np.array([3, 4, 4, 3, 4])
    one = kernels.mism_tile_plan(ii, jj)
    assert one.tiles == 1 and sorted(one.keys.tolist()) == [3, 4]
    assert ((one.slots & 0xFF) == (one.slots >> 8))[[0, 2, 3]].all()
    assert one.slots[1] == one.slots[4] and one.slots[0] == one.slots[3]
    two = kernels.mism_tile_plan(ii, jj, one_layout=False)
    assert sorted(two.keys.tolist()) == sorted([3, 4, ~3, ~4])
    assert ((two.slots & 0xFF) != (two.slots >> 8)).all()
    _check_plan(two, ii, jj, 28, one_layout=False)


def test_tile_plan_of_the_clustered_block():
    """Clusters of 21 consecutive samples, row-major: tiles of 24 samples
    take a cluster each with the next cluster's first pairs, so the tiles
    stage ~1.1 samples a cluster member and ~0.11 a pair (the warp kernel's
    2 a pair); ``stop_above`` gives up once the samples pass a bound."""
    ii, jj = _clustered_pairs(49, 21)
    plan = kernels.mism_tile_plan(ii, jj, samples=24)
    _check_plan(plan, ii, jj, 24)
    assert plan.tiles == 49 and len(plan.keys) < 0.12 * len(ii)
    # a cluster's 21 samples are 4 copies (8 + 8 + 4 + 1), the next one's first 3 are 2
    assert len(plan.boxes) <= 6 * plan.tiles
    same = kernels.mism_tile_plan(ii, jj, samples=24, stop_above=len(plan.keys))
    assert all(np.array_equal(x, y) for x, y in zip(same, plan))
    assert kernels.mism_tile_plan(ii, jj, samples=24, stop_above=len(plan.keys) - 1) is None


def test_tile_plan_rejects_bad_caps():
    with pytest.raises(ValueError):
        kernels.mism_tile_plan([0], [1], samples=1)
    with pytest.raises(ValueError):
        kernels.mism_tile_plan([0], [1], samples=kernels.MISM_TILE_SAMPLES + 1)
    with pytest.raises(ValueError):
        kernels.mism_tile_plan([0], [-1])


@pytest.mark.parametrize("case,want", [
    ("clustered", "tiled"), ("scattered", "warp"), ("dense rows", "warp"), ("one", "tiled"),
    ("a few scattered", "tiled"), ("self", "tiled"), ("pitch", "warp"), ("capacity", "warp"),
])
def test_design_rule(case, want):
    """The tiled kernel where it takes the operands and its tiles stage at
    most max(1024, P) samples; the warp kernel otherwise."""
    rng = np.random.default_rng(51)
    W, capacity = 8, 128
    ii, jj = _clustered_pairs(10, 21)
    if case == "scattered":
        ii, jj = rng.integers(0, 4096, 3000), rng.integers(0, 4096, 3000)
    elif case == "dense rows":   # every pair of a row block, no threshold
        ii, jj = np.triu_indices(4096, k=1)
        ii, jj = ii[:16374], jj[:16374]
    elif case == "one":
        ii, jj = np.array([3]), np.array([9])
    elif case == "a few scattered":
        ii, jj = rng.integers(0, 4096, 333), rng.integers(0, 4096, 333)
    elif case == "self":
        ii = jj = np.arange(4096)
    elif case == "pitch":
        W = 9
    elif case == "capacity":
        capacity = kernels.MISM_TILED_MAX_CAPACITY + 1
    pa = torch.zeros((4096, 4, W), dtype=torch.int32)
    design, plan = kernels.mism_design((pa,), W, ii, jj, capacity, True)
    assert design == want and (plan is None) == (want == "warp")
    if plan is not None:
        assert len(plan.keys) <= max(kernels.MISM_TILED_MIN_SAMPLES, len(ii))


def test_design_can_be_forced():
    ii, jj = np.array([3]), np.array([9])
    pa = torch.zeros((16, 4, 8), dtype=torch.int32)
    design, plan = kernels.mism_design((pa,), 8, ii, jj, 8, True, "tiled")
    assert design == "tiled" and plan.tiles == 1
    with pytest.raises(ValueError, match="multiple of"):
        kernels.mism_design((pa,), 9, ii, jj, 8, True, "tiled")
    assert kernels.mism_design((pa,), 8, *_clustered_pairs(3, 21), 8, True,
                               "warp") == ("warp", None)
    with pytest.raises(ValueError):
        kernels.mism_design((pa,), 8, ii, jj, 8, True, "fast")


def test_design_leaves_device_indices_alone_for_the_warp_kernel():
    """The rule copies the indices to the host only for a plan: operands the
    tiled kernel does not take go to the warp kernel without a look at them."""
    class Untouchable:
        def cpu(self):
            raise AssertionError("the indices were copied to the host")

    pa = torch.zeros((16, 4, 9), dtype=torch.int32)
    assert kernels.mism_design((pa,), 9, Untouchable(), Untouchable(), 8, True) == ("warp", None)


@pytest.mark.parametrize("tiles,n_chunks", [(49, 245), (49, 489), (1, 977), (400, 245),
                                            (5, 3), (3, 1), (7, 0), (132, 16)])
def test_parts_fill_the_card(tiles, n_chunks):
    """At least two waves of blocks on 132 SMs where the chunks allow, at most
    16 parts and no more parts than chunks."""
    k = kernels.mism_parts(tiles, n_chunks, 132)
    assert 1 <= k <= max(1, min(kernels.MISM_MAX_PARTS, n_chunks))
    if tiles * min(kernels.MISM_MAX_PARTS, n_chunks) >= 264:
        assert tiles * k >= 264
    else:
        assert k == max(1, min(kernels.MISM_MAX_PARTS, n_chunks))


_CU = Path(kernels.__file__).resolve().parents[1] / "csrc" / "mism_positions.cu"


def _cu_constant(name: str) -> int:
    m = re.search(rf"constexpr (?:int|unsigned) {name} = ([^;]+);", _CU.read_text())
    assert m, f"{name} is not in {_CU.name}"
    return int(eval(m.group(1).replace("u", "")))   # e.g. "216 * 1024"


@pytest.mark.parametrize("mirror,name", [
    ("MISM_TILE_SAMPLES", "kTileSamples"), ("MISM_CHUNK_WORDS", "kChunkWords"),
    ("MISM_TILE_PAIRS", "kMaxTilePairs"), ("MISM_MAX_PARTS", "kMaxParts"),
    ("MISM_TILE_WARPS", "kTileWarps"), ("MISM_TILED_MAX_CAPACITY", "kMaxCapacity"),
])
def test_chunk_words_fit_three_stages(mirror, name):
    """The wrapper's copies of the kernel's constants equal the source's, and
    three stages of a full tile's chunks (4 planes and a mask a sample) fit
    the ring, as the source's static_assert says."""
    assert getattr(kernels, mirror) == _cu_constant(name)
    stage = _cu_constant("kTileSamples") * 5 * _cu_constant("kChunkWords") * 4
    assert _cu_constant("kMinStages") == 3
    assert 3 * stage <= _cu_constant("kRingBytes") < 4 * stage


@pytest.mark.parametrize("length", [0, 5, 32 * 64 * 3, 32 * 64 * 3 + 1, 1_000_000])
@pytest.mark.parametrize("capacity", [0, 3, 128, 8192])
def test_launch_shape_covers_the_words_below_the_length(length, capacity):
    ii, jj = _clustered_pairs(6, 21)
    plan = kernels.mism_tile_plan(ii, jj)
    s = kernels.mism_launch_shape(plan, length, 132, capacity)
    words = -(-length // 32)
    assert s.n_chunks == -(-words // kernels.MISM_CHUNK_WORDS)
    assert s.parts >= 1 and (s.parts - 1) * s.part_chunks < max(1, s.n_chunks)
    assert s.parts * s.part_chunks >= s.n_chunks
    tile_pairs = int(np.diff(plan.pair_start).max())
    assert s.entry_cap % kernels.MISM_TILE_WARPS == 0
    assert s.entry_cap == max(32, min(kernels._MISM_ENTRY_CAP, tile_pairs * capacity) // 32 * 32)


def test_launch_shape_keeps_the_entries_in_budget():
    """Many tiles: a block keeps fewer entries, so the launch's stay within
    ``_MISM_ENTRY_BYTES`` (a block with more walks its part again)."""
    ii, jj = np.repeat(np.arange(0, 40000, 2), 3), np.repeat(np.arange(1, 40000, 2), 3)
    plan = kernels.mism_tile_plan(ii, jj, samples=2)
    s = kernels.mism_launch_shape(plan, 1_000_000, 132, 8192)
    assert plan.tiles == 20000 and s.entry_cap >= kernels.MISM_TILE_WARPS
    assert 8 * s.entry_cap * plan.tiles * s.parts <= kernels._MISM_ENTRY_BYTES


def _emulate_tiled(pa, pb, ma, mb, ii, jj, length, capacity, *, samples, parts, chunk):
    """The tiled kernel's walk in numpy: per (tile, part) block the part's
    mismatches of each pair with their rank inside the part, kept while the
    rank is below the capacity, the per-(pair, part) counts, and each pair's
    offset as the sum of the earlier parts' counts."""
    A, B = (t.numpy().view(np.uint32) for t in (pa, pb))
    NA, NB = (None, None) if ma is None else (t.numpy().view(np.uint32) for t in (ma, mb))
    plan = kernels.mism_tile_plan(ii, jj, samples=samples, one_layout=pb is pa)
    P, W = len(ii), A.shape[2]
    n_chunks = -(-(-(-length // 32)) // chunk)
    part_chunks = -(-n_chunks // parts) if n_chunks else 0
    parts = -(-n_chunks // part_chunks) if n_chunks else 1
    counts = np.zeros((parts, P), dtype=np.int64)
    found = {}
    for t in range(plan.tiles):
        p0, p1 = plan.pair_start[t], plan.pair_start[t + 1]
        keys = plan.keys[plan.key_start[t]:plan.key_start[t + 1]]
        for k in range(parts):
            w0 = k * part_chunks * chunk
            w1 = min(n_chunks, (k + 1) * part_chunks) * chunk
            entries = []
            for p in range(p0, p1):
                sa, sb = keys[plan.slots[p] & 0xFF], keys[plan.slots[p] >> 8]
                a = A[sa]
                b = B[~sb] if sb < 0 else A[sb]
                words = np.zeros(w1 - w0, dtype=np.uint32)
                inside = slice(w0, min(w1, W))
                shared = np.bitwise_or.reduce(a[:, inside] & b[:, inside], axis=0)
                if NA is not None:
                    nb = NB[~sb] if sb < 0 else NA[sb]
                    shared |= NA[sa][inside] | nb[inside]
                words[:len(shared)] = ~shared   # words past the pitch read as zeros
                bits = np.unpackbits(words.view(np.uint8), bitorder="little")
                pos = np.flatnonzero(bits) + 32 * w0
                pos = pos[pos < length]
                counts[k, p] = len(pos)
                entries += [(p, r, x) for r, x in enumerate(pos) if r < capacity]
            found[t, k] = entries
    out = np.full((P, 1 + capacity), -7, dtype=np.int64)
    prefix = np.cumsum(counts, axis=0) - counts
    for (t, k), entries in found.items():
        for p, r, x in entries:
            if prefix[k, p] + r < capacity:
                out[p, 1 + prefix[k, p] + r] = x
    total = counts.sum(axis=0)
    out[:, 0] = total
    for p in range(P):
        out[p, 1 + min(total[p], capacity):] = -1
    return out


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("pattern", PAIR_PATTERNS)
@pytest.mark.parametrize("parts,chunk,length", [(3, 32, 32 * 32 * 2), (2, 64, 32 * 70 - 9),
                                                (1, 128, 5)])
def test_parts_and_offsets_give_the_plain_table(pattern, masks, parts, chunk, length):
    """The design's arithmetic (tiles, parts, ranks inside a part, offsets
    from the earlier parts, the capacity cut and the -1 tail) gives the
    plain version's table, on every pair pattern, with a length at a part
    boundary, inside the last word, inside the first word."""
    rng = np.random.default_rng(52)
    W = 72
    pa, ma = _word_tensors(rng, 12, W)
    ii, jj = _pair_pattern(pattern, rng, 12)
    m = (ma, ma) if masks else (None, None)
    for capacity in (0, 24, 3000):
        want = kernels.mismatch_positions_reference(pa, None, ii, jj, length, capacity, *m)
        got = _emulate_tiled(pa, pa, *m, ii, jj, length, capacity, samples=4, parts=parts,
                             chunk=chunk)
        assert np.array_equal(got, want.numpy())


# -- on the card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_check(pa, pb, ii, jj, length, capacity, ma=None, mb=None):
    """The tiled kernel, forced, exact against the plain version."""
    before = profiling.counter("kernel.launches.mism_positions_tiled")
    got = kernels.mismatch_positions_kernel(pa, pb, ii, jj, length, capacity, ma, mb,
                                            _design="tiled")
    torch.cuda.synchronize()
    assert profiling.counter("kernel.launches.mism_positions_tiled") == before + 1
    want = kernels.mismatch_positions_reference(pa, pb, ii, jj, length, capacity, ma, mb)
    assert torch.equal(got, want)
    return want


def _shape(ii, jj, length, capacity, one_layout=True):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = kernels.mism_tile_plan(ii, jj, one_layout=one_layout)
    return plan, kernels.mism_launch_shape(plan, length, sms, capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("pattern", PAIR_PATTERNS)
@pytest.mark.parametrize("capacity", [0, 24, 8192])
def test_tiled_pair_patterns(card, pattern, masks, capacity):
    """Every pair pattern, W = 100 (no multiple of the chunk), a ragged
    length; capacity 0, below the counts (most sites mismatch) and 8192."""
    rng = np.random.default_rng(60)
    pa, ma = (t.to(card) for t in _word_tensors(rng, 12, 100))
    ii, jj = _pair_pattern(pattern, rng, 12)
    m = (ma, None) if masks else (None, None)
    want = _card_check(pa, None, ii, jj, 32 * 100 - 13, capacity, *m)
    if capacity == 24:
        assert int(want[:, 0].min()) > capacity


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("W", [132, 388, 1500, 4100])
def test_tiled_lengths_chunks_and_parts(card, masks, W):
    """Word counts that are no multiple of the 128-word chunk, cut by the
    wrapper into one part (a length inside the first word) and into 2 to 16
    parts (the whole length), with the length inside the first word, inside
    the last word and at the end of a chunk, where a part may end; rows that
    differ in a few words."""
    rng = np.random.default_rng(61 + W)
    pa, ma = (t.to(card) for t in _word_tensors(rng, 10, W))
    pa = pa[:1].expand(10, 4, W).clone() | 0x0F0F0F0F
    pa[:, 1, ::41] ^= torch.arange(1, 11, device=card, dtype=torch.int32)[:, None]
    ii, jj = _pair_pattern("runs", rng, 10)
    m = (ma, None) if masks else (None, None)
    chunk_sites = 32 * kernels.MISM_CHUNK_WORDS
    assert _shape(ii, jj, 5, 64)[1].parts == 1
    assert 2 <= _shape(ii, jj, 32 * W - 3, 64)[1].parts <= min(16, -(-W // 128))
    for length in (5, 32 * W - 3, chunk_sites * ((32 * W - 1) // chunk_sites)):
        _card_check(pa, None, ii, jj, length, 64, *m)


@pytest.mark.cuda
@pytest.mark.parametrize("masks", [False, True])
def test_tiled_one_pair_two_layouts_and_long_lists(card, masks):
    """P = 1; a query layout against a database layout (``b`` != ``a``);
    1,300 pairs over 7 samples (tiles cut at 512 pairs); clusters of 40
    samples, row-major, cut by tiles of 28 samples inside their runs."""
    rng = np.random.default_rng(62)
    pa, ma = (t.to(card) for t in _word_tensors(rng, 80, 64))
    pb, mb = (t.to(card) for t in _word_tensors(rng, 5, 64))
    m = (ma, mb) if masks else (None, None)
    _card_check(pa, pb, [4], [2], 32 * 64 - 1, 128, *m)
    _card_check(pa, pb, rng.integers(0, 80, 40), rng.integers(0, 5, 40), 2000, 128, *m)
    ma_only = (ma, None) if masks else (None, None)
    _card_check(pa, None, np.full(1300, 5), np.arange(1300) % 7, 32 * 64, 16, *ma_only)
    ii, jj = _clustered_pairs(2, 40)
    plan = kernels.mism_tile_plan(ii, jj)
    row_starts = set(np.flatnonzero(np.diff(ii)) + 1)
    assert any(int(s) not in row_starts for s in plan.pair_start[1:-1])
    _card_check(pa, None, ii, jj, 32 * 64 - 40, 2048, *ma_only)


@pytest.mark.cuda
def test_tiled_overflowing_entries_walk_again(card):
    """Dense mismatches at capacity 8192: a warp of a block keeps more
    (pair, rank, position) entries than its share of the block's scratch
    holds, so the block writes its positions in a second walk."""
    rng = np.random.default_rng(63)
    pa, ma = (t.to(card) for t in _word_tensors(rng, 6, 400))
    ii, jj = np.triu_indices(6, k=1)
    L = 32 * 400
    plan, shape = _shape(ii, jj, L, 8192)
    full = kernels.mismatch_positions_reference(pa, None, ii, jj, L, L, ma, None).cpu()
    part_sites = 32 * kernels.MISM_CHUNK_WORDS * shape.part_chunks
    pos = full[:, 1:]
    # a pair's kept entries in its part (each warp holds at most one pair here)
    in_part = max(int(((pos >= k * part_sites) & (pos < (k + 1) * part_sites)).sum(1).max())
                  for k in range(shape.parts))
    assert len(ii) <= kernels.MISM_TILE_WARPS
    assert min(in_part, 8192) > shape.entry_cap // kernels.MISM_TILE_WARPS
    _card_check(pa, None, ii, jj, L, 8192, ma, None)


@pytest.mark.cuda
def test_rule_takes_the_tiled_kernel_on_a_clustered_block(card):
    """Unforced, the wrapper launches the tiled kernel on a clustered
    row-major list at the main path's pitch and on a single pair, and the
    warp kernel on 3,000 pairs in no order; all exact."""
    dev = card
    rng = np.random.default_rng(64)
    W = 31_252
    base = torch.from_numpy(rng.integers(0, 2**32, size=(1, 4, W), dtype=np.uint32).view(np.int32))
    pa = base.to(dev).expand(63, 4, W).clone()
    pa[:, 2, ::501] ^= torch.arange(1, 64, device=dev, dtype=torch.int32)[:, None]
    ii, jj = _clustered_pairs(3, 21)
    far_i, far_j = rng.integers(0, 63, 3000), rng.integers(0, 63, 3000)   # in no order
    assert kernels.mism_design((pa,), W, far_i, far_j, 256, True)[0] == "warp"
    for pairs, tiled_launch in (((ii, jj), 1), (([3], [40]), 1), ((far_i, far_j), 0)):
        before = (profiling.counter("kernel.launches.mism_positions"),
                  profiling.counter("kernel.launches.mism_positions_tiled"))
        got = kernels.mismatch_positions_kernel(pa, None, *pairs, 32 * W - 64, 256)
        torch.cuda.synchronize()
        assert profiling.counter("kernel.launches.mism_positions") == before[0] + 1
        assert (profiling.counter("kernel.launches.mism_positions_tiled")
                == before[1] + tiled_launch)
        assert torch.equal(got, kernels.mismatch_positions_reference(pa, None, *pairs,
                                                                     32 * W - 64, 256))
