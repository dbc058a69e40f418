"""All-pairs SNP distances over bit-packed IUPAC alignments, on one device
(the split and popcount paths of tracs_tpu/ops/pairsnp.py, in PyTorch); over
a dp x sp mesh of processes the split path's sweep runs in
parallel/allpairs.py, which ``pairsnp_stream(mesh=...)`` calls.

Semantics: for a pair (i, j) a site *matches* when the two samples share at
least one allele bit (IUPAC codes set several bits, N sets all four); the
SNP distance is ``d = L - matches`` and the comparable-site count is
``nn = L - popcount(N_i | N_j)``.

Split decomposition.  With û = the N-exclusive planes and n = the N mask:

    matches(u, v) = (G4 - Gn) + Gpartial + cntN_u + cntN_v
    nn(u, v)      = L - cntN_u - cntN_v + Gn

G4 and Gn come from the hand-written gram kernel (ops/kernels.py
``split_gram``) straight from the packed words; Gpartial is a 10-channel
correction gram over the few sites where some sample holds a 2- or 3-bit
IUPAC code, from the kernel ``partial_gram``.  The self all-pairs sweep
computes, for a row block [r0, r1), only the columns j >= r0: the triangle
mask of the survivor extraction drops j <= i anyway.  The kernel
``coo_extract`` forms each pair's D and NN from the grams, keeps the
survivors (d <= dist) and compacts them in row-major order, so no D or NN
block is made; they are copied to the host once per block, while the card
already runs the next block.

Popcount engine (``method="popcount"``).  matches = sum popc(OR_x(a_x & b_x))
and nunion = sum popc(N_i | N_j) come straight from the raw planes through
the kernel ``popcount_gram`` (K2 + K3 in one pass): D = L - matches,
NN = L - nunion, with no split layout and no correction gram.  Same sweep
schedule, extraction and emission order as the split path.

Inclusion-exclusion engine (``method="mxu"``).  matches by inclusion-exclusion
over the 15 non-empty plane subsets S: with G_S the gram of the AND over S,
g = sum_S (-1)^|S| G_S = -matches and gq = G_ACGT (the N gram), so
D = L + g and NN = L - cntN_a - cntN_b + gq.  On the CPU ``_gram_mxu`` forms
the two grams in plain torch; on the card they are the popcount kernel's own
15 subset grams (``popcount_gram``: g = -matches, gq = cntN_a + cntN_b -
nunion), so there the engine runs the popcount engine's blocks.  ``auto`` picks between the engines by tracs_tpu's rule
(``_select_method``), which picks split on every alignment.

Recombination filter (``filter=True``).  Each block's survivors go through
ops/recomb.py::filter_pairs: the kernel ``mismatch_positions_kernel`` reads
the engine's resident layout and returns every pair's mismatch positions,
and the host runs the windowed binomial test on them in original genome
coordinates (the compaction's position map translates them).

Every result is an exact integer and equals the ``tracs_tpu`` value bit for
bit (tests/test_torch_pairsnp.py).
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from tracs_tpu_torch.ops.kernels import (
    _SUBSET_SIGNS,
    _as_words,
    _popcount,
    _subset_products,
    _unpack_bits,
    coo_extract_launch,
    mismatch_positions_kernel,
    pad_planes,
    partial_gram,
    popcount_gram,
    split_gram,
)
from tracs_tpu_torch.ops.packing import (
    PackedAlignment,
    SplitAlignment,
    compact_variant_columns,
    pack_fasta,
    partial_site_positions,
    popcount_words,
    split_alignment,
)
from tracs_tpu_torch.ops.recomb import filter_pairs
from tracs_tpu_torch.runtime.device import resolve_device, to_host
from tracs_tpu_torch.runtime.profiling import count, run_steps, span

INT32_MAX = 2**31 - 1

# bytes of unpacked float64 operands per chunk of ``_gram_mxu``
_PARTIAL_CHUNK_BYTES = 256 << 20

# bytes of one launch's [pairs, 1 + capacity] int32 position table
_MISM_TABLE_BYTES = 256 << 20

#: the signs (-1)^|S| of the 15 plane subsets in the mxu gram, and the channel
#: of the 4-plane subset (the N mask)
_MXU_SIGNS = [-s for s in _SUBSET_SIGNS]
_QUAD = 14

#: the method names; ``auto`` picks one of the others by ``_select_method``
METHODS = ("auto", "split", "popcount", "mxu")


def _device_layout(sa: SplitAlignment, device: torch.device) -> tuple:
    """(excl, nmask, partial, cnt_n) of a SplitAlignment on ``device``, held
    in ``sa._dev_cache``: the tensors ``split_alignment`` built there, or,
    for another device, that device's own, built once by the same route
    (``split_alignment``) from ``sa.src`` at ``sa.partial_pos`` and kept
    beside them."""
    device = resolve_device(device)
    held = getattr(sa, "_dev_cache", None)
    if held is None:
        held = sa._dev_cache = {}
    if device not in held:
        held[device] = split_alignment(sa.src, sa.partial_pos, device=device)._dev_cache[device]
    return held[device]


def _split_device(sa: SplitAlignment, device: torch.device):
    """(excl, nmask, partial) of a SplitAlignment on ``device``, at the card's
    word pitch ``padded_words`` (zero words past the sites, so a plane row
    starts on a 16-byte boundary whatever the sequence length; the partial
    planes on their own word axis by the same rule)."""
    return _device_layout(sa, device)[:3]


def _planes_device(packed: PackedAlignment, device: torch.device) -> torch.Tensor:
    """The raw planes [n, 4, W] of a PackedAlignment on ``device``, cached on
    it: the popcount engine's resident operand (the split path frees its own
    raw upload after building its layout, so the two engines keep separate
    copies).  Padded on the device with zero words to the pitch
    ``padded_words(W)``, so a plane row starts on a 16-byte boundary whatever
    the sequence length: a zero word adds nothing to ``matches`` or
    ``nunion``, and the mismatch-position kernel, to which it reads as 32
    mismatches, reports nothing at or past the length.  A miss is spanned
    and counted as ``split_alignment``'s upload is."""
    cache = getattr(packed, "_dev_planes", None)
    if cache is None or cache[0] != device:
        with span("layout.upload"):
            cache = (device, pad_planes(_as_words(packed.planes).to(device)))
        count("layout.upload_bytes", packed.planes.nbytes)
        packed._dev_planes = cache
    return cache[1]


def _cnt_device(sa: SplitAlignment, device: torch.device) -> torch.Tensor:
    """Per-sample N counts of a SplitAlignment as int32 on ``device``."""
    return _device_layout(sa, device)[3]


def _assemble_d(m, gp, cnt_a, cnt_b, L: int) -> torch.Tensor:
    match = m + cnt_a[:, None] + cnt_b[None, :]
    if gp is not None:
        match = match + gp
    return (L - match).to(torch.int32)


def _assemble_nn(gn, cnt_a, cnt_b, L: int) -> torch.Tensor:
    return (L - cnt_a[:, None] - cnt_b[None, :] + gn).to(torch.int32)


def _assemble_popcount(matches, nunion, L: int):
    return (L - matches).to(torch.int32), (L - nunion).to(torch.int32)


def _gram_mxu(pa: torch.Tensor, pb: torch.Tensor):
    """Signed channel gram and quad gram of raw planes [na, 4, W] and
    [nb, 4, W] (counterpart of tracs_tpu.ops.pairsnp._gram_mxu):
    g = sum_S (-1)^|S| G_S over the 15 plane subsets, gq = G_ACGT, int32
    [na, nb].  Contracted in float64 over unpacked 0/1 channels, which is
    exact, chunked over words so the operands stay under ~256 MB."""
    na, nb, W = pa.shape[0], pb.shape[0], pa.shape[2]
    f64 = dict(dtype=torch.float64, device=pa.device)
    signs = torch.tensor(_MXU_SIGNS, **f64)[None, :, None]
    acc = torch.zeros((na, nb), **f64)
    accq = torch.zeros((na, nb), **f64)
    chunk = max(1, _PARTIAL_CHUNK_BYTES // max(1, (na + 2 * nb) * 15 * 32 * 8))
    for w0 in range(0, W, chunk):
        w1 = min(W, w0 + chunk)
        ya = _unpack_bits(_subset_products(pa[:, :, w0:w1])).to(torch.float64)
        yb = _unpack_bits(_subset_products(pb[:, :, w0:w1])).to(torch.float64)
        acc += ya.reshape(na, -1) @ (yb * signs).reshape(nb, -1).T
        accq += ya[:, _QUAD] @ yb[:, _QUAD].T
    return acc.to(torch.int32), accq.to(torch.int32)


# The engines' grams of one block, rows [r0, r1) against columns [c0, n_b):
# each returns the keyword arguments of ``kernels.coo_extract`` that carry
# the block (its mode and gram blocks; the split engine's correction gram
# and N counts), from which the stream extracts the survivors and the dense
# functions assemble D and NN (``_assemble_block``).

def _popcount_grams(a: PackedAlignment, b: PackedAlignment, r0: int, r1: int, c0: int,
                    device: torch.device) -> dict:
    """The popcount engine's block: (matches, nunion) from the kernel
    ``popcount_gram``, so D = L - matches, NN = L - nunion."""
    pa = _planes_device(a, device)
    pb = None if b is a else _planes_device(b, device)
    matches, nunion = popcount_gram(pa, r0, r1 - r0, c0, pb)
    return {"mode": "direct", "g": matches, "gn": nunion}


def _cnt_n(packed: PackedAlignment, r0: int, r1: int | None) -> torch.Tensor:
    """Per-sample N counts of rows [r0, r1) of a PackedAlignment as int32, a
    host popcount of their N masks."""
    p = packed.planes[r0:r1]
    cnt = popcount_words(p[:, 0] & p[:, 1] & p[:, 2] & p[:, 3]).sum(axis=-1)
    return torch.from_numpy(cnt.astype(np.int32))


def _mxu_grams(a: PackedAlignment, b: PackedAlignment, r0: int, r1: int, c0: int,
               device: torch.device) -> dict:
    """The inclusion-exclusion engine's block as (matches, nunion).  On the
    card its 15 subset grams are the popcount kernel's own (g = -matches,
    gq = cntN_a + cntN_b - nunion), so the block is the popcount engine's;
    on the CPU ``_gram_mxu`` forms g and gq in plain torch and
    matches = -g, nunion = cntN_a + cntN_b - gq follow (D = L + g and
    NN = L - cntN_a - cntN_b + gq, tracs_tpu's ``_assemble_mxu``)."""
    if device.type != "cpu":
        return _popcount_grams(a, b, r0, r1, c0, device)
    pa = _planes_device(a, device)
    pb = pa if b is a else _planes_device(b, device)
    g, gq = _gram_mxu(pa[r0:r1], pb[c0:])
    nunion = _cnt_n(a, r0, r1)[:, None] + _cnt_n(b, c0, None)[None, :] - gq
    return {"mode": "direct", "g": -g, "gn": nunion}


def _split_grams(sa: SplitAlignment, sb: SplitAlignment, r0: int, r1: int, c0: int,
                 device: torch.device) -> dict:
    """The split engine's block: (g, gn) from the kernel ``split_gram``, the
    correction gram from ``partial_gram`` where some sample holds a partial
    IUPAC code, and the rows' and columns' N counts."""
    ea, nm, pa = _split_device(sa, device)
    if sb is sa:
        eb = nmb = None
        pb = pa
    else:
        eb, nmb, pb = _split_device(sb, device)
    g, gn = split_gram(ea, nm, r0, r1 - r0, c0, eb, nmb)
    gp = partial_gram(pa[r0:r1], pb[c0:]) if (sa.n_partial or sb.n_partial) else None
    return {"mode": "split", "g": g, "gn": gn, "gp": gp,
            "cnt_a": _cnt_device(sa, device)[r0:r1], "cnt_b": _cnt_device(sb, device)[c0:]}


def _block_grams(engine: str, a: PackedAlignment, b: PackedAlignment, r0: int, r1: int,
                 c0: int, device: torch.device) -> dict:
    """The grams of rows [r0, r1) of ``a`` against columns [c0, n_b) of ``b``
    through ``engine``."""
    if engine == "popcount":
        return _popcount_grams(a, b, r0, r1, c0, device)
    if engine == "mxu":
        return _mxu_grams(a, b, r0, r1, c0, device)
    sa, sb = _split_pair(a, b, device)
    return _split_grams(sa, sb, r0, r1, c0, device)


def _assemble_block(grams: dict, L: int):
    """(D, NN) int32 device blocks of an engine's block grams."""
    if grams["mode"] == "direct":
        return _assemble_popcount(grams["g"], grams["gn"], L)
    cnt_a, cnt_b = grams["cnt_a"], grams["cnt_b"]
    return (_assemble_d(grams["g"], grams["gp"], cnt_a, cnt_b, L),
            _assemble_nn(grams["gn"], cnt_a, cnt_b, L))


def _split_block(sa: SplitAlignment, sb: SplitAlignment, r0: int, r1: int,
                 c0: int, device: torch.device):
    """(D, NN) int32 device blocks of rows [r0, r1) of ``sa`` against
    columns [c0, n_b) of ``sb``."""
    return _assemble_block(_split_grams(sa, sb, r0, r1, c0, device), sa.length)


def snp_distance_split_prefix_device(sa: SplitAlignment, r0: int, r1: int, *,
                                     device: torch.device):
    """(D, NN, c0) — int32 device blocks of the triangle rows [r0, r1)
    against the column suffix [c0, n) with c0 = r0: a row block of the self
    all-pairs sweep only emits pairs with j > i >= r0, so the columns below
    r0 are never computed.  Column j of the [r1-r0, n-c0] blocks is global
    column j + c0; callers mask j <= i (the extraction's triangle mask
    does)."""
    n = sa.n_seqs
    if not 0 <= r0 < r1 <= n:
        raise ValueError(f"row range [{r0}, {r1}) outside [0, {n})")
    D, NN = _split_block(sa, sa, r0, r1, r0, device)
    return D, NN, r0


def _check_split_pair(sa: SplitAlignment, sb: SplitAlignment) -> None:
    """Raises unless the two layouts can be compared: one sequence length
    and, for a query-vs-db pair, one partial-site gather axis
    (``_split_pair`` builds them so)."""
    if sa.length != sb.length:
        raise ValueError("alignments must share sequence length")
    if sb is not sa and not np.array_equal(sa.partial_pos, sb.partial_pos):
        raise ValueError(
            "SplitAlignments of a pair must share the partial-site gather "
            "axis — build them with _split_pair(a, b)"
        )


def snp_distance_split_device(sa: SplitAlignment, sb: SplitAlignment | None = None,
                              *, chunk_sites: int | None = None, with_nn: bool = True,
                              device: torch.device, r0: int = 0, r1: int | None = None):
    """(D, NN) int32 device blocks of rows [r0, r1) of ``sa`` against every
    row of ``sb`` (default: ``sa``); NN is None unless ``with_nn``, as in
    tracs_tpu, and is then not assembled.  The two layouts of a query-vs-db
    pair must share the partial-site gather axis (``_split_pair`` builds them
    so).  ``chunk_sites`` is accepted for tracs_tpu's signature and ignored:
    it sizes the TPU's word chunks, and the kernels stage their own."""
    del chunk_sites
    if sb is None:
        sb = sa
    _check_split_pair(sa, sb)
    r1 = sa.n_seqs if r1 is None else r1
    if not 0 <= r0 <= r1 <= sa.n_seqs:
        raise ValueError(f"row range [{r0}, {r1}) outside [0, {sa.n_seqs}]")
    grams = _split_grams(sa, sb, r0, r1, 0, device)
    if not with_nn:
        return _assemble_d(grams["g"], grams["gp"], grams["cnt_a"], grams["cnt_b"],
                           sa.length), None
    return _assemble_block(grams, sa.length)


def snp_distance_dense_split(sa: SplitAlignment, sb: SplitAlignment | None = None, *,
                             chunk_sites: int | None = None, with_nn: bool = True,
                             device: str | torch.device):
    """Host (numpy) wrapper of ``snp_distance_split_device``: int32 [n_a, n_b]
    D and NN of two SplitAlignments (``sb`` defaults to ``sa``), NN None
    unless ``with_nn`` (counterpart of
    tracs_tpu.ops.pairsnp.snp_distance_dense_split; ``chunk_sites`` is
    ignored, as there)."""
    D, NN = snp_distance_split_device(sa, sb, with_nn=with_nn, device=resolve_device(device))
    return to_host(D), (None if NN is None else to_host(NN))


def comparable_sites_dense(sa: SplitAlignment, sb: SplitAlignment, *,
                           device: str | torch.device) -> np.ndarray:
    """Dense NN matrix, int32 numpy [n_a, n_b], of two SplitAlignments:
    L - cntN_i - cntN_j + Gn with Gn, the N-mask gram, from ``split_gram``
    (on the card the kernel's ``gn``, on the CPU its plain version)
    (counterpart of tracs_tpu.ops.pairsnp.comparable_sites_dense)."""
    device = resolve_device(device)
    _check_split_pair(sa, sb)
    ea, nm, _ = _split_device(sa, device)
    eb, nmb = (None, None) if sb is sa else _split_device(sb, device)[:2]
    _, gn = split_gram(ea, nm, 0, sa.n_seqs, 0, eb, nmb)
    NN = _assemble_nn(gn, _cnt_device(sa, device), _cnt_device(sb, device), sa.length)
    return to_host(NN)


def comparable_sites_pairs(sa: SplitAlignment, sb: SplitAlignment, pairs_i, pairs_j, *,
                           device: str | torch.device, batch: int = 65536) -> np.ndarray:
    """nn = L - popcount(N_i | N_j), int64 numpy, for the listed pairs only:
    the pairs' N-mask rows gathered from the layouts' tensors on ``device``
    and popcounted there in batches of ``batch`` pairs, so that millions of
    pairs never gather pairs x W words at once (counterpart of
    tracs_tpu.ops.pairsnp.comparable_sites_pairs); the pad words are zero
    and count nothing."""
    device = resolve_device(device)
    nm_a = _split_device(sa, device)[1]
    nm_b = nm_a if sb is sa else _split_device(sb, device)[1]
    pairs_i = np.asarray(pairs_i, dtype=np.int64)
    pairs_j = np.asarray(pairs_j, dtype=np.int64)
    out = np.empty(len(pairs_i), dtype=np.int64)
    for s in range(0, len(pairs_i), batch):
        e = min(len(pairs_i), s + batch)
        ii = torch.from_numpy(pairs_i[s:e]).to(device)
        jj = torch.from_numpy(pairs_j[s:e]).to(device)
        out[s:e] = sa.length - to_host(_popcount(nm_a[ii] | nm_b[jj]).sum(dim=-1))
    return out


def _launch_block(engine: str, a: PackedAlignment, b: PackedAlignment, r0: int, r1: int,
                  c0: int, dist: int, n_valid: int, triangle: bool,
                  device: torch.device) -> dict:
    """Queues one block of the sweep, spanned as ``sweep.grams``: the engine's
    grams, and under the key ``coo`` their extraction
    (``kernels.coo_extract_launch``), which ``_extract_coo`` then waits for."""
    with span("sweep.grams"):
        grams = _block_grams(engine, a, b, r0, r1, c0, device)
        grams["coo"] = coo_extract_launch(**grams, L=a.length, dist=dist, r0=r0, c0=c0,
                                          n_valid=n_valid, triangle=triangle)
    return grams


def _extract_coo(grams: dict, L: int, dist: int, r0: int, n_valid: int, c0: int, *,
                 triangle: bool):
    """Threshold + row-major compaction of one block's grams on their device
    (``kernels.coo_extract``: no D or NN block is made; launched here unless
    ``_launch_block`` did), with ONE device-to-host copy: the survivors' rows
    are one contiguous piece on the card, copied beside whatever was queued
    after the launch (``PendingCoo.host``).  Keeps ``D <= dist``, global
    column ``< n_valid`` and, on triangle blocks, global column > global row.
    Returns (rows_local, cols_global, dvals, nvals) as int64 numpy arrays in
    row-major order, the emission order of ``tracs_tpu``.  The span
    ``sweep.extract`` holds the wait for the block's kernels and the copy;
    the counter ``sweep.copied_bytes`` adds the bytes of the copy (16 a
    survivor)."""
    with span("sweep.extract"):
        pending = grams.get("coo")
        if pending is None:
            pending = coo_extract_launch(**grams, L=L, dist=dist, r0=r0, c0=c0,
                                         n_valid=n_valid, triangle=triangle)
        rows = pending.host()
        count("sweep.copied_bytes", rows.nbytes)
        rows_l, cols_l, dvals, nvals = rows.astype(np.int64).T
    return rows_l, cols_l + c0, dvals, nvals


def _cached_split(packed: PackedAlignment,
                  device: torch.device | None = None) -> SplitAlignment:
    """Build (and cache on the object) the SplitAlignment layout of a run on
    ``device`` (None: the CPU, as a mesh builds it); a cached layout of
    another device is replaced."""
    device = torch.device("cpu") if device is None else device
    split = getattr(packed, "_split_cache", None)
    if split is None or split.device != device:
        split = split_alignment(packed, device=device)
        packed._split_cache = split
    return split


def _split_pair(a: PackedAlignment, b: PackedAlignment | None,
                device: torch.device | None = None):
    """(sa, sb) SplitAlignments for a comparison pair, built as
    ``_cached_split`` builds them.  For a query-vs-db pair both sides are
    gathered at the union of their partial positions, so the correction
    gram's contraction axis lines up site for site.  Cached on ``a`` beside
    the partner itself and the device: the entry keeps ``b`` alive, so no
    later object can take its identity and be served its layout."""
    if b is None or b is a:
        sa = _cached_split(a, device)
        return sa, sa
    device = torch.device("cpu") if device is None else device
    cache = getattr(a, "_split_pair_cache", None)
    if cache is not None and cache[0] is b and cache[1] == device:
        return cache[2]
    pos = np.union1d(partial_site_positions(a), partial_site_positions(b))
    pair = (split_alignment(a, pos, device=device), split_alignment(b, pos, device=device))
    a._split_pair_cache = (b, device, pair)
    return pair


def _cached_compact(a: PackedAlignment, b: PackedAlignment):
    """compact_variant_columns, memoised on the first alignment beside the
    partner it was computed for (streaming resume re-enters with the same
    objects; the entry keeps ``b`` alive, as in ``_split_pair``)."""
    cache = getattr(a, "_compact_res", None)
    if cache is not None and cache[0] is b:
        return cache[1]
    res = compact_variant_columns(a, None if b is a else b)
    a._compact_res = (b, res)
    return res


def _select_method(a: PackedAlignment, b: PackedAlignment,
                   device: torch.device | None = None) -> str:
    """tracs_tpu's choice for ``auto``, by multiply-adds a site: the split
    decomposition costs ~5 a site + 10 a partial-IUPAC site (p of them, the
    union over the samples), the inclusion-exclusion gram ~16 a site.  mxu
    would need 10 p >= 11 L, and p <= L, so the rule picks split on every
    alignment, in tracs_tpu as here; it is kept so that ``auto`` runs what
    tracs_tpu runs.  The split layouts it reads are those of a run on
    ``device`` (``_split_pair``)."""
    sa, sb = _split_pair(a, b, device)
    p = max(sa.n_partial, sb.n_partial)
    return "split" if (5 * a.length + 10 * p) < (16 * a.length) else "mxu"


def _engine(method: str, a: PackedAlignment, b: PackedAlignment,
            device: torch.device | None = None) -> str:
    """The engine a method name runs on the pair (a, b) in a run on
    ``device``."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    return _select_method(a, b, device) if method == "auto" else method


def mismatch_positions_device(
    a: PackedAlignment, b: PackedAlignment, pairs_i, pairs_j, capacity: int,
    *, chunk: int = 256, device: str | torch.device, method: str = "split",
):
    """(counts [n_pairs] int64, positions [n_pairs, capacity] int64) of the
    sites where the two samples of each pair share no allele, ascending,
    from the layout ``method``'s engine keeps on ``device``: the split
    layout (N-exclusive planes and N masks) or, for ``popcount`` and
    ``mxu``, the raw planes.  Entries past a pair's count hold -1.  One
    kernel launch per ``_MISM_TABLE_BYTES`` of position table: the kernel
    reads the resident layout through the pair indices and needs no other
    buffer.  The zero words that pad either layout's pitch lie at and past
    ``a.length``, where the kernel reports nothing.  ``chunk`` is accepted
    for tracs_tpu's signature and ignored: it sizes the TPU's pair chunks,
    and the launches here are cut by table bytes.  The span
    ``filter.positions`` holds the launches and the tables' copies."""
    del chunk
    device = resolve_device(device)
    engine = _engine(method, a, b, device)
    if engine == "split":
        sa, sb = _split_pair(a, b, device)
        pa, ma, _ = _split_device(sa, device)
        pb, mb = (None, None) if sb is sa else _split_device(sb, device)[:2]
    else:
        pa, ma = _planes_device(a, device), None
        pb, mb = (None if b is a else _planes_device(b, device)), None
    n = len(pairs_i)
    ii = np.asarray(pairs_i, dtype=np.int64)
    jj = np.asarray(pairs_j, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    positions = np.empty((n, capacity), dtype=np.int64)
    chunk = max(1, _MISM_TABLE_BYTES // (4 * (1 + capacity)))
    with span("filter.positions"):
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            table = to_host(mismatch_positions_kernel(
                pa, pb, ii[s:e], jj[s:e], a.length, capacity, ma, mb))
            counts[s:e] = table[:, 0]
            positions[s:e] = table[:, 1:]
    return counts, positions


def mismatch_words(a: PackedAlignment, b: PackedAlignment, pairs_i, pairs_j) -> np.ndarray:
    """Per-pair mismatch bitsets on the host, uint32 [n_pairs, W]: a bit is
    set where the two samples share no allele; bits at or past the length
    are cleared.  The filter's path for pairs with more mismatches than the
    device route's capacity."""
    pa = a.planes[np.asarray(pairs_i, dtype=np.int64)]
    pb = b.planes[np.asarray(pairs_j, dtype=np.int64)]
    shared = (
        (pa[:, 0] & pb[:, 0])
        | (pa[:, 1] & pb[:, 1])
        | (pa[:, 2] & pb[:, 2])
        | (pa[:, 3] & pb[:, 3])
    )
    mism = ~shared
    tail_bits = a.planes.shape[2] * 32 - a.length
    if tail_bits:
        mism[:, -1] &= np.uint32(0xFFFFFFFF >> tail_bits)
    return mism


def snp_distance_dense(
    a: PackedAlignment,
    b: PackedAlignment | None = None,
    *,
    device: str | torch.device,
    method: str = "split",
    chunk_sites: int | None = None,
    row_block: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense all-pairs SNP distance and comparable-site matrices, int32
    numpy [n_a, n_b] (b defaults to a), computed in row blocks by the split
    engine, the popcount engine or the inclusion-exclusion engine (``method``
    ``split``, ``popcount``, ``mxu``; ``auto`` picks as tracs_tpu does).
    ``chunk_sites`` is accepted for tracs_tpu's signature and ignored: it
    sizes the TPU's word chunks, and the kernels stage their own."""
    del chunk_sites
    device = resolve_device(device)
    if b is None:
        b = a
    if a.length != b.length:
        raise ValueError("alignments must share sequence length")
    engine = _engine(method, a, b, device)
    D = np.empty((a.n_seqs, b.n_seqs), dtype=np.int32)
    NN = np.empty((a.n_seqs, b.n_seqs), dtype=np.int32)
    for r0 in range(0, a.n_seqs, row_block):
        r1 = min(a.n_seqs, r0 + row_block)
        Dd, Nd = _assemble_block(_block_grams(engine, a, b, r0, r1, 0, device), a.length)
        D[r0:r1] = to_host(Dd)
        NN[r0:r1] = to_host(Nd)
    return D, NN


@run_steps
def pairsnp_stream(
    fasta: Sequence[str] | Sequence[PackedAlignment],
    dist: int = INT32_MAX,
    filter: bool = False,
    *,
    device: str | torch.device,
    method: str = "split",
    row_block: int = 1024,
    start_row: int = 0,
    compact: bool = True,
    mesh=None,
):
    """Streaming COO emission for all-pairs runs.

    Yields ``(r0, r1, names, rows, cols, dvals, filt, nn)`` per row block
    (numpy arrays, row-major order within and across blocks), exactly what
    ``tracs_tpu.ops.pairsnp.pairsnp_stream`` yields.  One FASTA (or
    PackedAlignment) gives the all-pairs upper triangle j > i; two give the
    query-vs-db rectangle, with db columns offset by the query count.
    ``start_row`` resumes at a row-block boundary.  ``compact`` drops
    alignment columns that cannot change any result (bit-identical output).
    ``method`` picks the engine (``split``, ``popcount`` or ``mxu``; ``auto``
    picks as tracs_tpu does, on the compacted alignment); all yield the same
    arrays.  ``filter`` fills ``filt`` with the
    recombination-filtered distance of each emitted pair (ops/recomb.py);
    without it ``filt`` is zero-filled.

    ``mesh`` (a dp x sp ``DeviceMesh``, parallel/mesh.py) runs the split
    engine's sweep over the ranks of the mesh: the triangle ring
    (``RingCoo``) for a self all-pairs run from row 0 that fits its budget,
    the block sweep (``ShardedSweep``) otherwise.  Every rank of the mesh
    must call this with the same arguments (SPMD), and every rank yields the
    same arrays, those of the one-device run; the ring yields one block per
    dp stripe instead of per ``row_block``.  ``--filter`` then runs on each
    rank on its emitted rows with the whole alignment.  ``popcount`` and
    ``mxu`` ignore the mesh (logged).

    Each call is one run of runtime/profiling.py (it joins the caller's if
    one is open).  A call that sweeps counts ``sweep.runs`` once, as its
    first block starts, on one device and on a mesh alike.  Every block
    counts ``sweep.blocks``, ``sweep.pairs`` (the rows times the columns it
    sweeps) and ``sweep.survivors``; a block of the one-device sweep is
    spanned as ``sweep.grams`` (the launches of its grams and extraction)
    and ``sweep.extract`` (``_extract_coo``).  The one-device sweep
    launches block r + 1 before it takes block r's survivors, so the card
    works while the host copies and yields.
    ``sweep.copied_bytes`` counts the survivors' copy to the host in
    ``_extract_coo``, 16 B a survivor: on one device every survivor's, on a
    mesh each rank's own slab or stripe (the gather that follows is the
    collectives' traffic).
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    device = resolve_device(device)
    if len(fasta) < 1 or len(fasta) > 2:
        raise ValueError("Invalid number of fasta files!")
    packed = [p if isinstance(p, PackedAlignment) else pack_fasta(p) for p in fasta]
    a = packed[0]
    if len(packed) == 2:
        b = packed[1]
        if a.length != b.length:
            raise ValueError("Error reading FASTA, variable sequence lengths!")
        names = a.names + b.names
        col_offset = a.n_seqs
        triangle = False
    else:
        b = a
        names = a.names
        col_offset = 0
        triangle = True

    # kernels run on the compacted a_k/b_k; names, the filter's genome
    # length and its SNP coordinates stay in original space
    length = a.length
    pos_map = None
    nn_off = 0
    a_k, b_k = a, b
    if compact:
        comp = _cached_compact(a, b)
        if comp is not None:
            a_k, b_k, pos_map, nn_off = comp
            if b is a:
                b_k = a_k
    # one device builds its split layout there; a mesh builds it on the CPU,
    # from which each rank slices its shard
    layout_device = device if mesh is None else None
    engine = _engine(method, a_k, b_k, layout_device)
    ring = sweep = None
    if engine == "split":
        sa, sb = _split_pair(a_k, b_k, layout_device)
        if mesh is not None:
            from tracs_tpu_torch.parallel.allpairs import RingCoo, ShardedSweep

            if triangle and start_row == 0 and RingCoo.fits(
                sa.n_seqs, mesh, n_words=sa.src.planes.shape[2], device=device
            ):
                ring = RingCoo(sa, mesh, dist, device)
            else:
                sweep = ShardedSweep(sa, sb, mesh, device)
    elif mesh is not None:
        logging.info("mesh ignored by method %r: it runs on one device", engine)

    def emit(r0, r1, rows_l, cols, dvals, nvals):
        count("sweep.blocks")
        count("sweep.pairs", (r1 - r0) * (b.n_seqs - (r0 if triangle else 0)))
        count("sweep.survivors", len(rows_l))
        if nn_off:
            nvals = nvals + nn_off
        rows = rows_l + r0
        if filter and len(rows):
            filt = filter_pairs(a_k, b_k, rows, cols, dvals, length, device=device,
                                method=engine, position_map=pos_map)
        else:
            filt = np.zeros(len(rows), dtype=np.int64)
        return r0, r1, names, rows, cols + col_offset, dvals, filt, nvals

    def take(r0, r1, c0, grams):
        coo = _extract_coo(grams, a_k.length, dist, r0, b.n_seqs, c0, triangle=triangle)
        grams.clear()  # the block's grams leave the card before the caller takes the block
        return emit(r0, r1, *coo)

    if start_row < a.n_seqs:
        count("sweep.runs")
    if ring is not None:
        for r0, r1, *coo in ring.stripes():
            yield emit(r0, r1, *coo)
        return
    queued = None  # (r0, r1, c0, grams) of the block launched last
    for r0 in range(start_row, a.n_seqs, row_block):
        r1 = min(a.n_seqs, r0 + row_block)
        if sweep is not None:
            yield emit(r0, r1, *sweep.block(r0, r1, dist, triangle=triangle))
            continue
        # triangle blocks sweep the column suffix c0 = r0; rectangles c0 = 0
        c0 = r0 if triangle else 0
        grams = _launch_block(engine, a_k, b_k, r0, r1, c0, dist, b.n_seqs, triangle, device)
        # the card runs this block while the host takes the one before it
        if queued is not None:
            yield take(*queued)
        queued = (r0, r1, c0, grams)
    if queued is not None:
        yield take(*queued)


def pairsnp(
    fasta: Sequence[str] | Sequence[PackedAlignment],
    n_threads: int = 1,
    dist: int = INT32_MAX,
    filter: bool = False,
    *,
    device: str | torch.device,
    method: str = "split",
    row_block: int = 4096,
    compact: bool = True,
    mesh=None,
):
    """Reference-compatible driver: sparse COO of the pairs with d <= dist,
    in row-major order.  Returns (rows, cols, distances, seq_names,
    filt_distances, n_compared_sites) — Python lists up to 2^22 surviving
    pairs, int64 numpy arrays above that.  ``n_threads`` is accepted for API
    parity; the filtered column is zero-filled unless ``filter`` is set.
    ``mesh`` as in ``pairsnp_stream``: every rank calls this (SPMD)."""
    chunks = []  # per-block (rows, cols, d, filt, nn) numpy tuples
    names = None
    for _r0, _r1, names, rows, cols, dvals, filt, nvals in pairsnp_stream(
        fasta, dist=dist, filter=filter, device=device, method=method,
        row_block=row_block, compact=compact, mesh=mesh,
    ):
        chunks.append((rows, cols, dvals, filt, nvals))
    cat = [
        np.concatenate([np.asarray(c[k], dtype=np.int64) for c in chunks])
        if chunks else np.zeros(0, dtype=np.int64)
        for k in range(5)
    ]
    if len(cat[0]) <= 1 << 22:
        cat = [list(col) for col in cat]
    return cat[0], cat[1], cat[2], list(names), cat[3], cat[4]
