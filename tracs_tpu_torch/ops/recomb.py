"""Recombination / HGT filter: per-pair windowed binomial clustering test
(counterpart of tracs_tpu/ops/recomb.py; host numpy and scipy code, with the
mismatch positions extracted on the device by ops/pairsnp.py).

Reference semantics (src/pairsnp.hpp:223-318, ``filter_recomb`` +
``range_count``): given a pair's mismatch positions,

  * d <= 1            -> filtered distance = d
  * p = d / L, window half-width w = clamp(int(1/p/2 + 1), 50, 5000),
    significance threshold = 0.05 / d
  * for each SNP at position x: count SNPs inside [x-w, x+w+1) and the span
    from the first to the last in-window SNP inclusive (``range_count``
    returns that span, not the window width — pairsnp.hpp:242).
    Keep the SNP when the window holds only itself, or when
    1 - BinomCDF(n=span, p, k=count) >= 0.05/d (not significantly clustered).

Redesign: the reference rescans the SNP bitset per window (O(d) per SNP).
Here mismatch bitsets are unpacked once to sorted position vectors and the
window counts/spans come from two vectorised ``searchsorted`` calls — O(d log d)
per pair — with the binomial survival function evaluated in one vectorised
scipy call over every SNP of every pair in the batch.
"""

from __future__ import annotations

import numpy as np

from tracs_tpu_torch.runtime import profiling

_WIN_MIN = 50
_WIN_MAX = 5000


def _binom_sf(k, n, p):
    """scipy's binomial survival function.  scipy.stats is imported here, at
    the first call: it takes seconds to import, and every process of a
    multi-process run imports this module."""
    from scipy.stats import binom

    return binom.sf(k, n, p)


def mismatch_positions(words_row: np.ndarray) -> np.ndarray:
    """uint32 word bitset -> sorted positions of set bits."""
    bytes_ = words_row.view(np.uint8) if words_row.dtype == np.uint32 else words_row
    bits = np.unpackbits(bytes_, bitorder="little")
    return np.nonzero(bits)[0]


def filter_recomb_single(positions: np.ndarray, length: int) -> int:
    """Filtered SNP count for one pair given sorted mismatch positions."""
    d = len(positions)
    if d <= 1:
        return d
    p = d / length
    w = int(1.0 / p / 2.0 + 1.0)
    w = min(max(w, _WIN_MIN), _WIN_MAX)
    thresh = 0.05 / d

    lo = np.searchsorted(positions, positions - w, side="left")
    hi = np.searchsorted(positions, positions + w + 1, side="left")
    count = hi - lo
    first = positions[lo]
    last = positions[hi - 1]
    span = last - first + 1

    multi = count > 1
    keep = ~multi
    if np.any(multi):
        pv = _binom_sf(count[multi], span[multi], p)
        keep_multi = pv >= thresh
        keep = keep.astype(np.int64)
        keep[multi] = keep_multi
        return int(keep.sum())
    return int(keep.sum())


# device path capacity ceiling: pairs with more SNPs than this take the host
# bitset path (the [P, cap] position download would stop paying)
_DEVICE_FILTER_CAP = 8192


@profiling.spanned("filter")
def filter_pairs(
    a, b, rows, cols, dvals, length: int, *, device, method: str = "split",
    position_map: np.ndarray | None = None, chunk: int = 2048,
) -> np.ndarray:
    """Filtered distances for survivor pairs (rows, cols) of packed
    alignments ``a`` x ``b`` — the streaming sweep's filter entry point.

    Default route: mismatch SNP positions are extracted on ``device`` from
    the layout the sweep's engine (``method``) keeps resident there
    (pairsnp.mismatch_positions_device), and only [n_pairs, cap] position
    tables come back to the host: no host-side [n_pairs, L/8] bitsets (a
    10k-sample block can emit 10^5 survivors: ~12 GB of bitsets).  Pairs
    whose d exceeds the capacity ceiling (unthresholded runs) stream
    through the host bitset path in fixed-size chunks instead.

    Spans: ``filter`` (the call), ``filter.positions`` (the device step),
    ``filter.keep_table`` (each batch of tables built; the tables are counted
    in ``filter.keep_table_builds`` and their sf evaluations in
    ``filter.keep_table_sf_evals``) and ``filter.windows`` (the window pass).
    """
    from tracs_tpu_torch.ops.pairsnp import mismatch_positions_device, mismatch_words

    out = np.asarray(dvals, dtype=np.int64).copy()
    todo = np.nonzero(out > 1)[0]
    if todo.size == 0:
        return out

    d_todo = out[todo]
    cap = 1 << max(7, int(np.ceil(np.log2(max(2, d_todo.max())))))
    if cap <= _DEVICE_FILTER_CAP:
        counts, positions = mismatch_positions_device(
            a, b, rows[todo], cols[todo], cap, device=device, method=method
        )
        # the device mismatch popcount must equal the sweep's distance for
        # every pair (same formula); treat any disagreement as a bug
        if not np.array_equal(counts, d_todo):
            raise AssertionError(
                "device mismatch-position counts disagree with SNP distances"
            )
        valid = np.arange(cap)[None, :] < counts[:, None]
        pos = positions[valid]  # row-major -> sorted within each pair
        if position_map is not None:
            pos = position_map[pos]
        pair_idx = np.repeat(np.arange(todo.size), counts)
        out[todo] = _filter_flat(pair_idx, pos, d_todo, todo.size, length)
        return out

    for s in range(0, len(out), chunk):
        e = min(len(out), s + chunk)
        mism = mismatch_words(a, b, rows[s:e], cols[s:e])
        out[s:e] = filter_recomb_batch(
            mism, out[s:e], length, position_map=position_map
        )
    return out


def filter_recomb_batch(
    mism_words: np.ndarray,
    dvals: np.ndarray,
    length: int,
    *,
    batch: int = 512,
    position_map: np.ndarray | None = None,
) -> np.ndarray:
    """Vectorised filter over a batch of pairs.

    mism_words   : uint32 [n_pairs, W] mismatch bitsets (padding bits cleared)
    dvals        : per-pair SNP distance (== popcount of each bitset)
    length       : alignment length L (ORIGINAL coordinates)
    position_map : optional int64 monotonic map from bitset coordinates to
                   original genome coordinates — used when the bitsets come
                   from a variant-compacted alignment (ops/packing.py::
                   compact_variant_columns); window widths and spans are
                   always evaluated in original coordinates

    Returns int64 [n_pairs] filtered distances.

    Pairs are processed in fixed-size batches (unpacking every bitset at
    once materialises n_pairs x L bytes); within a batch the windowed
    statistics flatten into single searchsorted + binom.sf calls with
    unique-(count, span, d) memoisation.
    """
    out = np.asarray(dvals, dtype=np.int64).copy()
    n = mism_words.shape[0]
    if n == 0:
        return out
    if n > batch:
        for s in range(0, n, batch):
            e = min(n, s + batch)
            out[s:e] = filter_recomb_batch(
                mism_words[s:e], out[s:e], length, batch=batch,
                position_map=position_map,
            )
        return out

    todo = np.nonzero(out > 1)[0]
    if todo.size == 0:
        return out

    # sparse bit extraction: mismatch bitsets have ~d set bits out of L, so
    # only the nonzero WORDS are expanded (vs unpacking n_pairs x L bits)
    sub = mism_words[todo]
    pi_w, wi = np.nonzero(sub)
    wvals = sub[pi_w, wi]
    wbits = (wvals[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    bit_row, bit_col = np.nonzero(wbits)
    pair_idx = pi_w[bit_row]
    pos = wi[bit_row] * 32 + bit_col  # sorted per pair (row-major nonzero)
    if position_map is not None:
        pos = position_map[pos]  # monotonic -> stays sorted per pair

    out[todo] = _filter_flat(pair_idx, pos, out[todo], todo.size, length)
    return out


def _window_w(d, length):
    """Per-pair window half-width (reference pairsnp.hpp:266-271):
    clamp(1/(2p) + 1, WIN_MIN, WIN_MAX) with p = d/L, truncated to int."""
    d_t = np.asarray(d, dtype=np.float64)
    w = (1.0 / (d_t / length) / 2.0 + 1.0).astype(np.int64)
    return np.clip(w, _WIN_MIN, _WIN_MAX)


def _window_stats(pos, bounds, w_t, pair_idx, length):
    """Per-SNP (count, span) of in-window neighbours.  Native two-pointer
    sweep (O(n_snps)); without the native library two global searchsorted
    passes over positions offset by a per-pair stride."""
    from tracs_tpu_torch.runtime.native import native_window_stats

    res = native_window_stats(pos, bounds, w_t)
    if res is not None:
        return res

    w_flat = w_t[pair_idx]
    # windows can never cross segment boundaries after a stride offset
    stride = length + 2 * _WIN_MAX + 2
    gpos = pos + pair_idx * stride
    lo = np.searchsorted(gpos, pos - w_flat + pair_idx * stride, side="left")
    hi = np.searchsorted(gpos, pos + w_flat + 1 + pair_idx * stride, side="left")
    span = pos[hi - 1] - pos[lo] + 1
    return (hi - lo).astype(np.int32), span


# keep-decision tables: for a given (d, length) the window width, the
# success probability p = d/L and the significance threshold 0.05/d are all
# fixed, so the keep decision is a pure function of (count, span) — a small
# bool table per d (count <= _SF_TABLE_CAP covers essentially every window;
# larger counts fall through to direct sf evaluation).  Replaces the
# reference's per-(count, span, p) hash-map memoisation (pairsnp.hpp:41-58)
# and the previous per-batch np.unique over triples, whose structured sort
# dominated the filter (measured 39s of a 47s batch at 200k pairs).
_SF_TABLE_CAP = 16
_keep_tables: dict = {}


def _first_kept_spans(d, widths, length):
    """int64 [len(d), _SF_TABLE_CAP - 1]: for each distance of ``d``, whose
    table is ``widths`` (2w + 2) spans wide, and each count
    2.._SF_TABLE_CAP, the least span n in [0, 2w + 1] with
    binom.sf(count, n, d/L) >= 0.05/d, or 2w + 2 where there is none.

    For a fixed count the survival function strictly increases with n
    (P_{n+1}(X > k) - P_n(X > k) = p P_n(X = k)), so a row's keep decisions
    are false up to one span and true from it on.  Where they switch, sf is
    near 0.05/d, deep in the upper tail, and its step from n to n + 1 (about
    (k + 1)/n relative) dwarfs scipy's rounding, so the computed values
    switch there once too.  Every row is bisected at once, each step calling
    ``_binom_sf`` on the rows still open (counted in
    ``filter.keep_table_sf_evals``): ~15 log2(2w + 3) evaluations a table in
    place of the 15 (2w + 2) of the whole grid, on the same (k, n, p) doubles
    and against the same threshold, so the tables are the grid's own."""
    rows = _SF_TABLE_CAP - 1
    k = np.tile(np.arange(2, _SF_TABLE_CAP + 1, dtype=np.int64), len(d))
    p = np.repeat(d / length, rows)
    thresh = np.repeat(0.05 / d, rows)
    lo = np.zeros(k.size, dtype=np.int64)
    hi = np.repeat(widths, rows)
    while True:
        todo = np.nonzero(lo < hi)[0]
        if todo.size == 0:
            return lo.reshape(len(d), rows)
        mid = (lo[todo] + hi[todo]) // 2
        profiling.count("filter.keep_table_sf_evals", int(todo.size))
        kept = _binom_sf(k[todo], mid, p[todo]) >= thresh[todo]
        hi[todo] = np.where(kept, mid, hi[todo])
        lo[todo] = np.where(kept, lo[todo], mid + 1)


def _keep_tables_for(d_values, length):
    """The keep tables of the distances ``d_values`` (each > 1), in that
    order: bool [(_SF_TABLE_CAP - 1), 2w + 2] each, keep[count - 2, span].
    The distances without a table yet are built in one batch: the span
    ``filter.keep_table`` around it, one ``filter.keep_table_builds`` a
    table."""
    want = [int(d) for d in d_values]
    tabs = {d: _keep_tables[(d, length)] for d in want if (d, length) in _keep_tables}
    new = np.unique(np.array([d for d in want if d not in tabs], dtype=np.int64))
    if new.size:
        if len(_keep_tables) + new.size > 4096:  # bound process-level growth
            _keep_tables.clear()
        profiling.count("filter.keep_table_builds", int(new.size))
        with profiling.span("filter.keep_table"):
            widths = 2 * _window_w(new, length) + 2
            first = _first_kept_spans(new, widths, length)
            for d, width, f in zip(new.tolist(), widths.tolist(), first):
                tab = np.arange(width, dtype=np.int64)[None, :] >= f[:, None]
                _keep_tables[(d, length)] = tabs[d] = tab
    return [tabs[d] for d in want]


def _keep_table(d, length):
    """bool [(_SF_TABLE_CAP - 1), 2w + 2] — keep[count - 2, span]."""
    return _keep_tables_for([d], length)[0]


def _keep_lookup(count, span, d_u, d_inv_flat, length):
    """keep iff binom.sf(count, span, d/L) >= 0.05/d, for count > 1.
    ``d_u``/``d_inv_flat``: unique pair distances and each SNP's rank into
    them (ranking happens at the pair level — re-deriving it from the flat
    per-SNP d vector would sort 10^8 elements)."""
    keep = np.empty(len(count), dtype=bool)
    small = count <= _SF_TABLE_CAP
    if np.any(small):
        cs, ss = count[small], span[small]
        d_inv = d_inv_flat[small]
        tabs = _keep_tables_for(d_u, length)
        widths = np.array([t.shape[1] for t in tabs], dtype=np.int64)
        offs = np.concatenate([[0], np.cumsum(widths * (_SF_TABLE_CAP - 1))])
        flat = np.concatenate([t.ravel() for t in tabs])
        idx = offs[d_inv] + (cs.astype(np.int64) - 2) * widths[d_inv] + ss
        keep[small] = flat[idx]
    big = ~small
    if np.any(big):
        # rare (heavily clustered windows): unique on a packed scalar key —
        # count and span are both <= 2*WIN_MAX + 1, d is ranked, so the key
        # stays far below 2^63
        sb = np.int64(2 * _WIN_MAX + 2)
        nd = np.int64(len(d_u))
        key = (count[big].astype(np.int64) * sb + span[big]) * nd + d_inv_flat[big]
        uniq, inv = np.unique(key, return_inverse=True)
        du = np.asarray(d_u)[uniq % nd]
        rem = uniq // nd
        pv = _binom_sf(rem // sb, rem % sb, du.astype(np.float64) / length)
        keep[big] = (pv >= 0.05 / du)[inv]
    return keep


def _filter_flat_native(pos, bounds, w_t, d_per_pair, length):
    """One native pass: (count, span) two-pointer sweep with the keep
    decision resolved inline from per-pair tables — no flat [n_snps] numpy
    passes at all (those dominated the filter at 10^8 SNPs).  Returns
    int64 kept[n_pairs] or None when the native library is unavailable."""
    from tracs_tpu_torch.runtime.native import native_filter_windows

    d_u, d_rank = np.unique(
        np.asarray(d_per_pair, dtype=np.int64), return_inverse=True
    )
    tabs = _keep_tables_for(d_u, length)
    sizes = np.array([t.size for t in tabs], dtype=np.int64)
    offs_u = np.concatenate([[0], np.cumsum(sizes)])
    flat = np.concatenate(
        [np.ascontiguousarray(t, dtype=np.uint8).ravel() for t in tabs]
    )
    widths_u = np.array([t.shape[1] for t in tabs], dtype=np.int64)
    with profiling.span("filter.windows"):
        res = native_filter_windows(
            pos, bounds, w_t, flat, offs_u[:-1][d_rank], widths_u[d_rank],
            _SF_TABLE_CAP,
        )
    if res is None:
        return None
    kept, ovf = res
    if ovf.any():
        # rare: windows holding more than _SF_TABLE_CAP SNPs — recompute
        # (count, span) via the native stats pass and subtract the
        # rejected ones per pair (the keep pass counted them provisionally)
        from tracs_tpu_torch.runtime.native import native_window_stats

        idx = np.nonzero(ovf)[0]
        snp_pair = np.searchsorted(bounds, idx, side="right") - 1
        count, span = native_window_stats(pos, bounds, w_t)
        ovf_keep = _keep_lookup(
            count[idx], span[idx], d_u, d_rank[snp_pair], length
        )
        rejects = np.bincount(
            snp_pair[~ovf_keep], minlength=len(kept)
        ).astype(np.int64)
        kept -= rejects
    return kept


def _filter_flat(pair_idx, pos, d_per_pair, n_todo, length):
    """Windowed-binomial filter core over flat (pair_idx, pos) vectors.

    pair_idx   : int [n_snps] pair segment of each SNP (nondecreasing)
    pos        : int [n_snps] SNP positions, sorted within each segment
                 (ORIGINAL genome coordinates)
    d_per_pair : int64 [n_todo] SNP distance per pair (all > 1)
    Returns int64 [n_todo] kept-SNP counts.  Shared by the host bitset
    path (filter_recomb_batch) and the device position-extraction path
    (filter_pairs)."""
    w_t = _window_w(d_per_pair, length)
    bounds = np.searchsorted(pair_idx, np.arange(n_todo + 1), side="left")
    kept = _filter_flat_native(pos, bounds, w_t, d_per_pair, length)
    if kept is not None:
        return np.where(bounds[1:] > bounds[:-1], kept, 0)
    with profiling.span("filter.windows"):
        count, span = _window_stats(pos, bounds, w_t, pair_idx, length)

    multi = count > 1
    keep = np.ones(len(pos), dtype=bool)
    if np.any(multi):
        d_u, d_rank = np.unique(
            np.asarray(d_per_pair, dtype=np.int64), return_inverse=True
        )
        d_inv_flat = d_rank[pair_idx[multi]]
        keep[multi] = _keep_lookup(
            count[multi], span[multi], d_u, d_inv_flat, length
        )

    kept_per_pair = np.add.reduceat(keep.astype(np.int64), bounds[:-1])
    # reduceat quirk: empty segments copy the next element; d > 1 segments are
    # never empty here, but guard anyway
    return np.where(bounds[1:] > bounds[:-1], kept_per_pair, 0)
