"""The benchmark's own inputs, made from ``--seed``: clustered bit-packed
alignments and their sampling dates.

A copy of the port's ``experiments/workload.py::make_clustered`` (itself the
JAX package's ``bench.py`` workload) and of ``chip_smoke.py::write_dates``,
kept here so that later changes to the program cannot change the yardstick.
Two departures, neither of which changes an array: the N share of the random
base genomes is a parameter (the original's 14% is a constant), and the
substitutions and partial-IUPAC columns are applied to all samples at once
after the random draws, which are made in the original's order.
"""

from __future__ import annotations

from datetime import date, timedelta

import numpy as np

#: bit order of the planes: bit0=A, bit1=C, bit2=G, bit3=T; N sets all four
_CODES = np.array([1, 2, 4, 8, 15], dtype=np.uint8)


def nibbles_to_planes(nibbles: np.ndarray) -> np.ndarray:
    """[n, L] uint8 4-bit masks -> [n, 4, ceil(L/32)] uint32 bit-planes
    (site s in word s // 32, bit s % 32)."""
    n, L = nibbles.shape
    W = (L + 31) // 32
    pad = W * 32 - L
    if pad:
        nibbles = np.pad(nibbles, ((0, 0), (0, pad)))
    planes = np.empty((n, 4, W), dtype=np.uint32)
    for p in range(4):
        packed = np.packbits((nibbles >> p) & 1, axis=-1, bitorder="little")
        b = packed.reshape(n, W, 4).astype(np.uint32)
        planes[:, p] = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    return planes


def random_planes(n: int, L: int, n_share: float, seed: int) -> np.ndarray:
    """n random packed genomes: A, C, G, T in equal shares and N at
    ``n_share``, cut from one random site pool at 32-site offsets."""
    rng = np.random.default_rng(seed)
    probs = np.array([(1.0 - n_share) / 4.0] * 4 + [n_share])
    counts = np.diff(np.round(np.concatenate([[0.0], np.cumsum(probs)]) * 256))
    lut = np.repeat(_CODES, counts.astype(np.int64))
    pool_L = L + 32 * n
    nib = lut[rng.integers(0, 256, size=pool_L, dtype=np.uint8)]
    pool_planes = nibbles_to_planes(nib[None, :])[0]  # [4, Wp]
    W = (L + 31) // 32
    planes = np.empty((n, 4, W), dtype=np.uint32)
    for i in range(n):
        planes[i] = pool_planes[:, i: i + W]
    tail = W * 32 - L
    if tail:
        planes[:, :, -1] &= np.uint32(0xFFFFFFFF >> tail)
    return planes


def make_clustered(n: int, L: int, *, cluster_size: int, max_mut: int,
                   n_partial_cols: int, n_share: float, seed: int) -> np.ndarray:
    """uint32 planes [n, 4, ceil(L/32)]: clusters of ``cluster_size`` copies
    of a random base genome, each with 5..``max_mut`` point substitutions,
    plus ``n_partial_cols`` columns where every sample holds M or R."""
    n_clusters = (n + cluster_size - 1) // cluster_size
    bases = random_planes(n_clusters, L, n_share, seed)
    rng = np.random.default_rng(seed + 1)
    max_mut = min(max_mut, max(5, L // 16))
    n_partial_cols = min(n_partial_cols, L // 8)
    W = bases.shape[2]
    planes = bases[np.arange(n) // cluster_size]
    sample, pos, newbase = [], [], []
    for i in range(n):
        k = int(rng.integers(min(5, max_mut), max_mut + 1))
        pos.append(rng.choice(L, size=k, replace=False))
        newbase.append(rng.integers(0, 4, size=k))
        sample.append(np.full(k, i, dtype=np.int64))
    sample, pos, newbase = (np.concatenate(x) for x in (sample, pos, newbase))
    flat = planes.reshape(-1)
    word = sample * 4 * W + pos // 32
    bit = np.uint32(1) << (pos % 32).astype(np.uint32)
    for c in range(4):
        np.bitwise_and.at(flat, word + c * W, ~bit)
    np.bitwise_or.at(flat, word + newbase * W, bit)
    if n_partial_cols:
        cols = rng.choice(L, size=n_partial_cols, replace=False)
        is_m = np.stack([rng.integers(0, 2, size=n_partial_cols) == 0 for _ in range(n)])
        w, b = cols // 32, (cols % 32).astype(np.uint32)
        mask = np.zeros(W, dtype=np.uint32)
        np.bitwise_or.at(mask, w, np.uint32(1) << b)
        planes &= ~mask
        planes[:, 0] |= mask  # the A bit of both codes
        is_m_t = np.ascontiguousarray(is_m.T)  # [cols, n]
        for plane, chosen in ((1, is_m_t), (2, ~is_m_t)):  # M = A|C, R = A|G
            code_bits = np.zeros((W, n), dtype=np.uint32)
            # columns that share a bit position lie in distinct words
            for k in np.unique(b):
                sel = np.nonzero(b == k)[0]
                code_bits[w[sel]] |= chosen[sel].astype(np.uint32) << k
            planes[:, plane] |= code_bits.T
    return planes


def sample_days(n: int, cluster_size: int, seed: int) -> np.ndarray:
    """Sampling day of each sample, counted from 2019-01-01: a base day in
    2019-2021 for each cluster and 0-180 days after it for each member."""
    rng = np.random.default_rng(seed + 2)
    n_clusters = -(-n // cluster_size)
    base = rng.integers(0, 3 * 365, size=n_clusters)
    offset = rng.integers(0, 181, size=n)
    return base[np.arange(n) // cluster_size] + offset


def write_dates(path: str, n: int, cluster_size: int, seed: int) -> None:
    """The dates CSV of ``distance --meta``: header, then ``name,ISO date``
    for samples named 0..n-1."""
    day0 = date(2019, 1, 1)
    lines = [f"{i},{(day0 + timedelta(days=int(d))).isoformat()}\n"
             for i, d in enumerate(sample_days(n, cluster_size, seed))]
    with open(path, "w") as fh:
        fh.write("name,date\n")
        fh.writelines(lines)


def alignment(cfg: dict, seed: int) -> np.ndarray:
    """The configuration's planes for ``seed``."""
    return make_clustered(cfg["samples"], cfg["sites"], cluster_size=cfg["cluster_size"],
                          max_mut=cfg["max_mutations"], n_partial_cols=cfg["partial_columns"],
                          n_share=cfg["n_share"], seed=seed)
