"""The benchmark's own inputs, made from ``--seed``: bit-packed alignments
and their sampling dates.

A configuration's ``structure`` key chooses the alignment's shape:

- ``"clusters"`` (also when the key is absent): clusters of copies of
  independent random genomes, each copy with its own few substitutions
  (``make_clustered``).  A copy of the port's
  ``experiments/workload.py::make_clustered`` (itself the JAX package's
  ``bench.py`` workload), kept here so that later changes to the program
  cannot change the yardstick.  Two departures, neither of which changes an
  array: the N share of the random base genomes is a parameter (the
  original's 14% is a constant), and the substitutions and partial-IUPAC
  columns are applied to all samples at once after the random draws, which
  are made in the original's order.
- ``"clock"``: every sample descends from one random root genome, with
  substitutions placed by a molecular clock on the sampling dates and N
  drawn for each sample (``make_clock_tree``), as in a collection of one
  pathogen's genomes.
- ``"mixtures"``: samples of one species, some of which carry two or more
  strains (``make_mixtures``): founders drawn from one root's biallelic
  segregating sites, members with their own substitutions, and a share of
  samples whose code at each site is the OR of their strains' bases, the
  IUPAC codes that ``align`` calls when every strain passes its frequency
  threshold; then each sample's own N and the M/R columns.

``sample_days`` and ``write_dates`` copy ``chip_smoke.py::write_dates``.
"""

from __future__ import annotations

from datetime import date, timedelta
from typing import NamedTuple

import numpy as np

#: bit order of the planes: bit0=A, bit1=C, bit2=G, bit3=T; N sets all four
_CODES = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
STRUCTURES = ("clusters", "clock", "mixtures")
#: the keys a mixtures configuration has to give
MIXTURE_KEYS = ("samples", "sites", "cluster_size", "max_mutations", "n_share",
                "partial_columns", "segregating_share", "minor_allele_share", "mixed_share",
                "strains")
#: days in the program's year of 31,556,952 s
DAYS_A_YEAR = 365.2425


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


def planes_to_nibbles(planes: np.ndarray, L: int) -> np.ndarray:
    """[n, 4, W] uint32 bit-planes -> [n, L] uint8 4-bit masks."""
    n, _, W = planes.shape
    bits = np.unpackbits(np.ascontiguousarray(planes).view(np.uint8), axis=-1,
                         bitorder="little").reshape(n, 4, W * 32)[:, :, :L]
    return (bits << np.arange(4, dtype=np.uint8)[None, :, None]).sum(axis=1, dtype=np.uint8)


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


def _substitute(planes: np.ndarray, sample, pos, newbase) -> None:
    """Writes base ``newbase`` (0..3: A, C, G, T) at site ``pos`` of
    ``sample`` in the contiguous ``planes``, in place; the sites of one
    sample are distinct."""
    W = planes.shape[2]
    flat = planes.reshape(-1)
    word = sample * 4 * W + pos // 32
    bit = np.uint32(1) << (pos % 32).astype(np.uint32)
    for c in range(4):
        np.bitwise_and.at(flat, word + c * W, ~bit)
    np.bitwise_or.at(flat, word + newbase * W, bit)


def _partial_columns(planes: np.ndarray, rng, L: int, n_partial_cols: int) -> None:
    """Sets ``min(n_partial_cols, L // 8)`` columns drawn by ``rng`` to M or
    R (drawn for each sample) in every sample, in place."""
    n, _, W = planes.shape
    n_partial_cols = min(n_partial_cols, L // 8)
    if not n_partial_cols:
        return
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


def make_clustered(n: int, L: int, *, cluster_size: int, max_mut: int,
                   n_partial_cols: int, n_share: float, seed: int) -> np.ndarray:
    """uint32 planes [n, 4, ceil(L/32)]: clusters of ``cluster_size`` copies
    of a random base genome, each with 5..``max_mut`` point substitutions,
    plus ``n_partial_cols`` columns where every sample holds M or R."""
    n_clusters = (n + cluster_size - 1) // cluster_size
    bases = random_planes(n_clusters, L, n_share, seed)
    rng = np.random.default_rng(seed + 1)
    max_mut = min(max_mut, max(5, L // 16))
    planes = bases[np.arange(n) // cluster_size]
    sample, pos, newbase = [], [], []
    for i in range(n):
        k = int(rng.integers(min(5, max_mut), max_mut + 1))
        pos.append(rng.choice(L, size=k, replace=False))
        newbase.append(rng.integers(0, 4, size=k))
        sample.append(np.full(k, i, dtype=np.int64))
    _substitute(planes, *(np.concatenate(x) for x in (sample, pos, newbase)))
    _partial_columns(planes, rng, L, n_partial_cols)
    return planes


def _distinct_sites(rng, counts: np.ndarray, L: int, taken=None):
    """(group, site) int64 arrays of ``counts[g]`` distinct sites in [0, L)
    for each group g, in group order, none of them among the ``taken``
    (group, site) pairs.  A draw that repeats a taken site or an earlier
    draw of its group is drawn again, until none does."""
    group = np.repeat(np.arange(len(counts)), counts)
    site = rng.integers(0, L, size=len(group))
    fixed = np.zeros(0, dtype=np.int64) if taken is None else taken[0] * L + taken[1]
    while True:
        keys = np.concatenate([fixed, group * L + site])
        order = np.argsort(keys, kind="stable")
        repeats = np.zeros(len(keys), dtype=bool)
        repeats[order[1:]] = keys[order[1:]] == keys[order[:-1]]
        again = np.nonzero(repeats[len(fixed):])[0]
        if not again.size:
            return group, site
        site[again] = rng.integers(0, L, size=again.size)


def _new_bases(rng, root_code: np.ndarray, site: np.ndarray) -> np.ndarray:
    """A base (0..3) for each substituted site: one of the three other than
    the root's (which holds no N)."""
    code = root_code[site]
    base = np.argmax((code[:, None] >> np.arange(4, dtype=np.uint8)) & 1, axis=1)
    return (base + 1 + rng.integers(0, 3, size=len(site))) % 4


def _n_sites(planes: np.ndarray, rng, L: int, n_share: float) -> None:
    """Sets each site of each sample to N with probability ``n_share`` (in
    steps of 1/256, as ``random_planes``), drawn for each sample, in place.
    A byte a site, drawn for up to 1,024 samples at a time and at most
    32 MiB: larger buffers would be mapped and faulted in anew for every
    draw.  How the samples are grouped leaves the bytes unchanged."""
    n, _, W = planes.shape
    below = int(round(n_share * 256))
    if not below:
        return
    rows = max(1, min(1024, (32 << 20) // (W * 32)))
    for lo in range(0, n, rows):
        # the bytes that rng.integers(0, 256, dtype=np.uint8) would draw, in
        # its order (the low byte of each 32-bit draw first), four at a time
        draw = rng.integers(0, 2**32, size=(min(rows, n - lo), W * 8), dtype=np.uint32)
        is_n = draw.view(np.uint8) < below
        is_n[:, L:] = False
        mask = np.packbits(is_n, axis=-1, bitorder="little").view(np.uint32)
        planes[lo: lo + rows] |= mask[:, None, :]


def day_parts(n: int, cluster_size: int, seed: int):
    """(base day of each cluster, counted from 2019-01-01, in 2019-2021;
    days of each sample after its cluster's base day, 0-180): the draws of
    ``sample_days``."""
    rng = np.random.default_rng(seed + 2)
    n_clusters = -(-n // cluster_size)
    base = rng.integers(0, 3 * 365, size=n_clusters)
    offset = rng.integers(0, 181, size=n)
    return base, offset


def sample_days(n: int, cluster_size: int, seed: int) -> np.ndarray:
    """Sampling day of each sample, counted from 2019-01-01: a base day in
    2019-2021 for each cluster and 0-180 days after it for each member."""
    base, offset = day_parts(n, cluster_size, seed)
    return base[np.arange(n) // cluster_size] + offset


def clock_substitutions(root: np.ndarray, L: int, *, n: int, cluster_size: int,
                        clock_rate: float, seed: int, rng):
    """The substitutions of ``make_clock_tree`` as two (index, site, base)
    triples of int64 arrays: each cluster's founder's, indexed by cluster,
    and each sample's own, indexed by sample.

    Cluster c's founder lives at the cluster's base day and carries
    Poisson(``clock_rate`` x base years) distinct sites, where the root
    (day 0) lives at 2019-01-01; each member carries its founder's and
    Poisson(``clock_rate`` x its years after the base day) distinct sites
    of its own, none of them its founder's.  A count is cut to the sites
    there are.  Draws from ``rng`` in this order: founders' counts, sites
    and bases, then the members'."""
    base_day, offset = day_parts(n, cluster_size, seed)
    root_code = planes_to_nibbles(root, L)[0]
    k = np.minimum(rng.poisson(clock_rate * base_day / DAYS_A_YEAR), L)
    cluster, f_site = _distinct_sites(rng, k, L)
    founders = (cluster, f_site, _new_bases(rng, root_code, f_site))
    inherited = _inherited(founders, n, cluster_size)
    held = np.bincount(inherited[0], minlength=n)
    m = np.minimum(rng.poisson(clock_rate * offset / DAYS_A_YEAR), L - held)
    sample, p_site = _distinct_sites(rng, m, L, inherited[:2])
    return founders, (sample, p_site, _new_bases(rng, root_code, p_site))


def _inherited(founders, n: int, cluster_size: int):
    """(sample, site, base) of every founder substitution that each member
    of its cluster carries, in sample order."""
    cluster, site, base = founders
    counts = np.bincount(cluster, minlength=-(-n // cluster_size))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    own = counts[np.arange(n) // cluster_size]
    sample = np.repeat(np.arange(n), own)
    first = np.repeat(starts[np.arange(n) // cluster_size] - np.cumsum(own) + own, own)
    entry = first + np.arange(len(sample))
    return sample, site[entry], base[entry]


def make_clock_tree(n: int, L: int, *, cluster_size: int, clock_rate: float,
                    n_partial_cols: int, n_share: float, seed: int) -> np.ndarray:
    """uint32 planes [n, 4, ceil(L/32)] that descend from one random root
    genome (no N) by a clock of ``clock_rate`` substitutions a genome a year
    on the days of ``sample_days``, with clusters of ``cluster_size``
    samples that share a founder (``clock_substitutions``); then each
    sample's own N, at ``n_share`` of its sites (``_n_sites``), and
    ``n_partial_cols`` columns where every sample holds M or R, as
    ``make_clustered`` makes them."""
    root = random_planes(1, L, 0.0, seed)
    rng = np.random.default_rng(seed + 1)
    founders, private = clock_substitutions(root, L, n=n, cluster_size=cluster_size,
                                            clock_rate=clock_rate, seed=seed, rng=rng)
    planes = np.repeat(root, n, axis=0)
    _substitute(planes, *(np.concatenate(x) for x in zip(_inherited(founders, n, cluster_size),
                                                          private)))
    _n_sites(planes, rng, L, n_share)
    _partial_columns(planes, rng, L, n_partial_cols)
    return planes


class MixtureDraws(NamedTuple):
    """The draws of ``make_mixtures``, in the order they are made."""

    #: int64 [S] ascending segregating sites, and the alternative base
    #: (0..3: A, C, G, T) of each, never the root's
    seg_site: np.ndarray
    seg_base: np.ndarray
    #: bool [clusters, S]: each cluster's founder holds the alternative base
    alleles: np.ndarray
    #: (sample, site, base) int64 arrays of each member's own substitutions
    own: tuple
    #: int64 [m] ascending mixed samples, and int64 [m, strains - 1] the
    #: samples whose strains each carries besides its own
    mixed: np.ndarray
    donors: np.ndarray


def mixture_draws(root: np.ndarray, L: int, *, n: int, cluster_size: int, max_mut: int,
                  segregating_share: float, minor_allele_share: float, mixed_share: float,
                  strains: int, rng) -> MixtureDraws:
    """The draws of ``make_mixtures`` from ``rng``, in this order:
    ``round(segregating_share x L)`` distinct segregating sites and an
    alternative base for each; each founder's alleles, the alternative with
    probability ``minor_allele_share`` at each site (float32 draws, 1,024
    founders at a time); each member's 5..``max_mut`` distinct sites of its
    own (``make_clustered``'s ranges) and a base (0..3) for each; the
    ``round(mixed_share x n)`` mixed samples; and for each of them
    ``strains - 1`` donors, each drawn uniformly from the samples of the
    other clusters."""
    if strains < 2:
        raise ValueError(f"strains {strains}: a mixture carries 2 or more")
    n_clusters = -(-n // cluster_size)
    root_code = planes_to_nibbles(root, L)[0]
    seg_site = np.sort(rng.choice(L, size=int(round(segregating_share * L)), replace=False))
    seg_base = _new_bases(rng, root_code, seg_site)
    alleles = np.concatenate(
        [rng.random((min(1024, n_clusters - lo), len(seg_site)), dtype=np.float32)
         < minor_allele_share for lo in range(0, n_clusters, 1024)])
    max_mut = min(max_mut, max(5, L // 16))
    k = rng.integers(min(5, max_mut), max_mut + 1, size=n)
    sample, site = _distinct_sites(rng, k, L)
    own = (sample, site, rng.integers(0, 4, size=len(site)))
    mixed = np.sort(rng.choice(n, size=int(round(mixed_share * n)), replace=False))
    if len(mixed) and n_clusters < 2:
        raise ValueError("a mixture takes its strains from other clusters: there is one")
    lo = mixed // cluster_size * cluster_size
    size = (np.minimum(n, lo + cluster_size) - lo)[:, None]
    donors = rng.integers(0, n - size, size=(len(mixed), strains - 1))
    donors += (donors >= lo[:, None]) * size
    return MixtureDraws(seg_site, seg_base, alleles, own, mixed, donors)


def _founder_planes(root: np.ndarray, draws: MixtureDraws) -> np.ndarray:
    """uint32 planes [clusters, 4, W] of the founders: the root with the
    alternative base at each segregating site that a founder holds, 1,024
    founders at a time."""
    _, _, W = root.shape
    alt = np.zeros((4, W * 32), dtype=bool)
    alt[draws.seg_base, draws.seg_site] = True
    alt = np.packbits(alt, axis=-1, bitorder="little").view(np.uint32)  # [4, W]
    founders = np.empty((len(draws.alleles), 4, W), dtype=np.uint32)
    for lo in range(0, len(founders), 1024):
        chunk = draws.alleles[lo: lo + 1024]
        held = np.zeros((len(chunk), W * 32), dtype=bool)
        held[:, draws.seg_site] = chunk
        held = np.packbits(held, axis=-1, bitorder="little").view(np.uint32)[:, None, :]
        founders[lo: lo + 1024] = (root & ~held) | (held & alt)
    return founders


def _mix(planes: np.ndarray, mixed: np.ndarray, donors: np.ndarray) -> None:
    """ORs the strains of each mixed sample's donors into it, in place,
    1,024 mixed samples at a time; every strain is read before any sample
    is mixed."""
    extra = np.empty((len(mixed),) + planes.shape[1:], dtype=np.uint32)
    for lo in range(0, len(mixed), 1024):
        chunk = donors[lo: lo + 1024]
        extra[lo: lo + 1024] = planes[chunk[:, 0]]
        for k in range(1, chunk.shape[1]):
            extra[lo: lo + 1024] |= planes[chunk[:, k]]
    for lo in range(0, len(mixed), 1024):
        planes[mixed[lo: lo + 1024]] |= extra[lo: lo + 1024]


def make_mixtures(n: int, L: int, *, cluster_size: int, max_mut: int, segregating_share: float,
                  minor_allele_share: float, mixed_share: float, strains: int,
                  n_partial_cols: int, n_share: float, seed: int) -> np.ndarray:
    """uint32 planes [n, 4, ceil(L/32)] of one species: a random root genome
    (no N); clusters of ``cluster_size`` samples whose founder holds, at
    each of the root's biallelic segregating sites, the alternative base
    with probability ``minor_allele_share``; each member its founder plus
    substitutions of its own; each sample's genome so far its strain.  A
    share ``mixed_share`` of the samples carry the strains of
    ``strains - 1`` samples of other clusters besides their own: their code
    at a site is the OR of their strains' bases (``mixture_draws``).  Then
    each sample's own N, at ``n_share`` of its sites (``_n_sites``), and
    ``n_partial_cols`` columns where every sample holds M or R, as
    ``make_clustered`` makes them."""
    root = random_planes(1, L, 0.0, seed)
    rng = np.random.default_rng(seed + 1)
    draws = mixture_draws(root, L, n=n, cluster_size=cluster_size, max_mut=max_mut,
                          segregating_share=segregating_share,
                          minor_allele_share=minor_allele_share, mixed_share=mixed_share,
                          strains=strains, rng=rng)
    planes = _founder_planes(root, draws)[np.arange(n) // cluster_size]
    _substitute(planes, *draws.own)
    _mix(planes, draws.mixed, draws.donors)
    _n_sites(planes, rng, L, n_share)
    _partial_columns(planes, rng, L, n_partial_cols)
    return planes


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
    """The configuration's planes for ``seed``, in its ``structure``.  A
    clock configuration reads ``clock_rate`` and takes no ``max_mutations``
    (a null one counts as none, so that an override can take it away); a
    mixtures configuration reads every key of ``MIXTURE_KEYS``."""
    structure = cfg.get("structure", "clusters")
    if structure == "clusters":
        return make_clustered(cfg["samples"], cfg["sites"], cluster_size=cfg["cluster_size"],
                              max_mut=cfg["max_mutations"],
                              n_partial_cols=cfg["partial_columns"], n_share=cfg["n_share"],
                              seed=seed)
    if structure == "clock":
        if cfg.get("max_mutations") is not None:
            raise ValueError("a clock configuration takes no max_mutations: "
                             "its substitutions follow clock_rate")
        return make_clock_tree(cfg["samples"], cfg["sites"], cluster_size=cfg["cluster_size"],
                               clock_rate=cfg["clock_rate"],
                               n_partial_cols=cfg["partial_columns"], n_share=cfg["n_share"],
                               seed=seed)
    if structure == "mixtures":
        missing = [k for k in MIXTURE_KEYS if cfg.get(k) is None]
        if missing:
            raise ValueError(f"a mixtures configuration needs {', '.join(missing)}")
        return make_mixtures(cfg["samples"], cfg["sites"], cluster_size=cfg["cluster_size"],
                             max_mut=cfg["max_mutations"],
                             segregating_share=cfg["segregating_share"],
                             minor_allele_share=cfg["minor_allele_share"],
                             mixed_share=cfg["mixed_share"], strains=cfg["strains"],
                             n_partial_cols=cfg["partial_columns"], n_share=cfg["n_share"],
                             seed=seed)
    raise ValueError(f"structure {structure!r}: one of {', '.join(STRUCTURES)}")
