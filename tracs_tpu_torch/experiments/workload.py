"""Seeded synthetic alignments for measurements: the headline workload of
the JAX package's ``bench.py`` (``make_clustered``), in the port's own numpy
code, array for array what ``bench.py`` builds.
"""

from __future__ import annotations

import numpy as np

from tracs_tpu_torch.ops.packing import PackedAlignment, nibbles_to_planes


def random_planes(n: int, L: int, seed: int = 0) -> np.ndarray:
    """n random packed samples, ~86% unambiguous calls and 14% N, cut from
    one random site pool at 32-site offsets (bench.py::_random_planes)."""
    rng = np.random.default_rng(seed)
    probs = np.array([0.215] * 4 + [0.14])
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    counts = np.diff(np.round(np.concatenate([[0.0], np.cumsum(probs)]) * 256))
    lut = np.repeat(codes, counts.astype(np.int64))
    pool_L = L + 32 * n
    nib = lut[rng.integers(0, 256, size=pool_L, dtype=np.uint8)]
    pool_planes = nibbles_to_planes(nib[None, :])[0]  # [4, Wp]
    W = (L + 31) // 32
    planes = np.empty((n, 4, W), dtype=np.uint32)
    for i in range(n):
        planes[i] = pool_planes[:, i : i + W]
    tail = W * 32 - L
    if tail:
        planes[:, :, -1] &= np.uint32(0xFFFFFFFF >> tail)
    return planes


def _mutate_inplace(planes, positions, rng) -> None:
    """Unambiguous point substitutions of one sample's packed planes."""
    w = (positions // 32).astype(np.int64)
    b = (positions % 32).astype(np.uint32)
    clear = ~(np.uint32(1) << b)
    setb = np.uint32(1) << b
    for c in range(4):
        np.bitwise_and.at(planes[c], w, clear)
    newbase = rng.integers(0, 4, size=positions.shape[0])
    np.bitwise_or.at(planes, (newbase, w), setb)


def make_clustered(n, L, cluster_size=6, max_mut=90, n_partial_cols=2048, seed=0):
    """bench.py::make_clustered: clusters of mutated copies of random base
    genomes, plus shared columns of partial codes M/R in every sample.
    Every within-cluster pair lands under a SNP threshold of 200 and no
    other pair does.  Returns the port's PackedAlignment."""
    n_clusters = (n + cluster_size - 1) // cluster_size
    bases = random_planes(n_clusters, L, seed=seed)
    rng = np.random.default_rng(seed + 1)
    max_mut = min(max_mut, max(5, L // 16))
    n_partial_cols = min(n_partial_cols, L // 8)
    planes = np.empty((n, 4, bases.shape[2]), dtype=np.uint32)
    for i in range(n):
        planes[i] = bases[i // cluster_size]
        k = int(rng.integers(min(5, max_mut), max_mut + 1))
        pos = rng.choice(L, size=k, replace=False)
        _mutate_inplace(planes[i], pos, rng)
    if n_partial_cols:
        cols = rng.choice(L, size=n_partial_cols, replace=False)
        w = (cols // 32).astype(np.int64)
        setb = np.uint32(1) << (cols % 32).astype(np.uint32)
        clear = ~setb
        for i in range(n):
            is_m = rng.integers(0, 2, size=n_partial_cols) == 0  # M else R
            for c in range(4):
                np.bitwise_and.at(planes[i, c], w, clear)
            np.bitwise_or.at(planes[i, 0], w, setb)  # A bit in both codes
            np.bitwise_or.at(planes[i, 1], w[is_m], setb[is_m])
            np.bitwise_or.at(planes[i, 2], w[~is_m], setb[~is_m])
    return PackedAlignment(planes=planes, length=L, names=[str(i) for i in range(n)])
