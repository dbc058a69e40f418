"""The recombination filter of tracs' pairsnp (src/pairsnp.hpp,
``filter_recomb`` and ``range_count``) in NumPy and SciPy.

For a pair with d > 1 mismatch sites out of L: p = d / L, half-width
w = clamp(int(1 / p / 2 + 1), 50, 5000), threshold 0.05 / d.  A mismatch at
x is kept when [x - w, x + w + 1) holds no other mismatch, or when
binom.sf(count, span, p) >= 0.05 / d, with count the mismatches in that
window and span the sites from its first to its last, inclusive.  The
filtered distance is the number kept; d <= 1 stays d.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import binom

_WIN_MIN, _WIN_MAX = 50, 5000


def filtered_distances(pair: np.ndarray, site: np.ndarray, n_pairs: int,
                       length: int) -> np.ndarray:
    """int64 [n_pairs] filtered distances from every mismatch (pair, site),
    sites ascending within each pair and pairs nondecreasing."""
    d = np.bincount(pair, minlength=n_pairs).astype(np.int64)
    if len(site) == 0:
        return d
    dd = d[pair].astype(np.float64)
    p = dd / length
    w = np.clip((1.0 / p / 2.0 + 1.0).astype(np.int64), _WIN_MIN, _WIN_MAX)
    # windows never reach across pairs once each pair has its own stretch
    stride = length + 2 * _WIN_MAX + 2
    key = site + pair * stride
    lo = np.searchsorted(key, key - w, side="left")
    hi = np.searchsorted(key, key + w + 1, side="left")
    count = hi - lo
    span = site[hi - 1] - site[lo] + 1
    keep = count <= 1
    test = np.nonzero(~keep)[0]
    if test.size:
        triple = np.stack([count[test], span[test], d[pair[test]]], axis=1)
        uniq, inv = np.unique(triple, axis=0, return_inverse=True)
        sf = binom.sf(uniq[:, 0], uniq[:, 1], uniq[:, 2] / length)
        keep[test] = (sf >= 0.05 / uniq[:, 2])[inv.reshape(-1)]
    kept = np.bincount(pair, weights=keep, minlength=n_pairs).astype(np.int64)
    return np.where(d <= 1, d, kept)
