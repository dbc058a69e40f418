#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tracs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each one passes or the script exits non-zero):

0. the card's name and power limit, from nvidia-smi;
1. the build of every kernel of the distance path from the sources in the
   checkout (one nvcc per source, all started together, sm_90a), with its
   seconds and ptxas report;
2. each kernel against its plain PyTorch version on the card, exact equality,
   at a ragged shape, a rectangle with r0 > 0 and c0 > 0, and the main-path
   shape rb=1024 x n=4096 x W=31250, with the median ms of both:
   ``split_gram`` (K1) and ``popcount_gram`` (K2 + K3);
3. the distance slice through the normal entry point
   (``tracs_tpu_torch.cli.main(["distance", ...])``) on the headline
   workload: n=4096 samples x 1 Mb in clusters of 21, 2048 partial-IUPAC
   columns, seed 0, written as an uncompressed FASTA in a temp dir.  Checks
   that every row block launched the split-gram kernel, that the CSV holds
   exactly the within-cluster pairs, and that 2,000 sampled rows agree with a
   host numpy popcount over the raw planes.  Prints wall seconds, pairs/s and
   the CSV's sha256;
4. the sweep alone (``pairsnp_stream``) through both engines, cold and warm:
   the popcount engine must launch ``popcount_gram`` once per row block and
   yield, array for array, what the split engine yields;
5. ``distance --meta`` through the CLI on the same workload, with a seeded
   date per sample (a base date per cluster, members 0-180 days after it):
   the split kernel once per row block, the same rows as phase 3, p0 in
   [0, 1], E(K) finite and >= 0, and 2,000 sampled rows against the scalar
   ``lprob_k_given_N`` and the model run on the CPU (rtol 1e-9);
6. ``trans_dist`` alone on the card: its time on the run's unique (N, delta)
   lanes, and the reference goldens at 1e-6.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: row block of the distance run: the JAX package's headline setting
ROW_BLOCK = 1024
#: the kernels of the distance path, built from csrc/<name>.cu
KERNELS = ("split_gram", "popcount_gram")
#: the transmission model's defaults (tracs distance --clock_rate/--trans_rate/--precision)
LAMB, BETA, PRECISION = 1e-3 * 29903, 73.0, 0.01


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# the headline workload: bench.py's make_clustered, in the port's numpy code
# ---------------------------------------------------------------------------

def random_planes(n: int, L: int, seed: int = 0) -> np.ndarray:
    """n random packed samples, ~86% unambiguous calls and 14% N, cut from
    one random site pool at 32-site offsets (bench.py::_random_planes)."""
    from tracs_tpu_torch.ops.packing import nibbles_to_planes

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
    from tracs_tpu_torch.ops.packing import PackedAlignment

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


def write_fasta(path: str, packed, batch: int = 128) -> None:
    """Uncompressed FASTA of a PackedAlignment, one line per sequence."""
    from tracs_tpu_torch.ops.packing import IUPAC_BY_NIBBLE, unpack_planes_to_nibbles

    chars = IUPAC_BY_NIBBLE.view(np.uint8)
    with open(path, "wb") as fh:
        for s in range(0, packed.n_seqs, batch):
            text = chars[unpack_planes_to_nibbles(packed.planes[s : s + batch], packed.length)]
            for k in range(text.shape[0]):
                fh.write(b">" + packed.names[s + k].encode() + b"\n")
                fh.write(text[k].tobytes())
                fh.write(b"\n")


def oracle(planes: np.ndarray, length: int, i: np.ndarray, j: np.ndarray):
    """(SNP distance, sites considered) of pairs (i, j) by a host popcount
    over the raw planes: d = L - popcount(OR_x(a_x & b_x)),
    nn = L - popcount(N_a | N_b)."""
    from tracs_tpu_torch.ops.packing import popcount_words

    d = np.empty(len(i), dtype=np.int64)
    nn = np.empty(len(i), dtype=np.int64)
    for k in range(0, len(i), 64):
        a, b = planes[i[k : k + 64]], planes[j[k : k + 64]]
        shared = (a[:, 0] & b[:, 0]) | (a[:, 1] & b[:, 1]) | (a[:, 2] & b[:, 2]) | (a[:, 3] & b[:, 3])
        na = a[:, 0] & a[:, 1] & a[:, 2] & a[:, 3]
        nb = b[:, 0] & b[:, 1] & b[:, 2] & b[:, 3]
        d[k : k + 64] = length - popcount_words(shared).sum(axis=1)
        nn[k : k + 64] = length - popcount_words(na | nb).sum(axis=1)
    return d, nn


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events around each run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _random_words(device, seed: int):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=device,
                             generator=gen)
    return words


#: name, A rows, B rows (None: self), W, r0, rb, c0
KERNEL_CASES = [
    ("ragged n=37 W=17", 37, None, 17, 0, 37, 0),
    ("rectangle 37x11 r0=5 c0=3", 48, 14, 17, 5, 37, 3),
    ("main path rb=1024 n=4096 W=31250", 4096, None, 31250, 0, 1024, 0),
]


def phase_kernels(device, seed: int):
    """Each kernel against its plain version on the card at KERNEL_CASES;
    returns {kernel: (max_abs_err of each output, kernel ms, plain ms)}, the
    times at the main-path shape."""
    import torch

    from tracs_tpu_torch.ops import kernels

    words = _random_words(device, seed)

    def split_args(na, nb, W, r0, rb, c0):
        b = (None, None) if nb is None else (words(nb, 4, W), words(nb, W))
        return (words(na, 4, W), words(na, W), r0, rb, c0) + b

    def popcount_args(na, nb, W, r0, rb, c0):
        return (words(na, 4, W), r0, rb, c0, None if nb is None else words(nb, 4, W))

    specs = {
        "split_gram": (kernels.split_gram, kernels.split_gram_reference, split_args),
        "popcount_gram": (kernels.popcount_gram, kernels.popcount_gram_reference,
                          popcount_args),
    }
    out = {}
    for kname, (fn, plain, make) in specs.items():
        errs = [0, 0]
        ms = plain_ms = None
        for name, na, nb, W, r0, rb, c0 in KERNEL_CASES:
            args = make(na, nb, W, r0, rb, c0)
            got = fn(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)]
            errs = [max(e, f) for e, f in zip(errs, err)]
            print(f"# {kname} vs plain, {name}: out {tuple(got[0].shape)}, max |err| {err}")
            if any(err):
                fail(f"{kname} disagrees with its plain version at {name}")
            if W == 31250:
                ms = time_ms(lambda: fn(*args), 10)
                plain_ms = time_ms(lambda: plain(*args), 3)
                print(f"# {kname} at {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median)")
            del args, got, want
            torch.cuda.empty_cache()
        out[kname] = (errs, ms, plain_ms)
    return out


def _headline(n: int, L: int, seed: int, tmp: str):
    """(packed alignment, FASTA path, cluster size) of the headline workload."""
    cluster_size = max(6, round(0.005 * n) + 1)
    t0 = time.perf_counter()
    packed = make_clustered(n, L, cluster_size=cluster_size, seed=seed)
    fasta = os.path.join(tmp, "clustered.fasta")
    write_fasta(fasta, packed)
    print(f"# workload: n={n} L={L} clusters of {cluster_size}, FASTA "
          f"{os.path.getsize(fasta) / 1e9:.2f} GB written in {time.perf_counter() - t0:.1f} s")
    return packed, fasta, cluster_size


def _run_cli(argv, n: int, row_block: int, what: str, device):
    """One ``distance`` CLI run with the launch counts set to 0 just before
    it; returns (wall s, split_gram launches, CSV rows as field lists, sha256)."""
    import torch

    from tracs_tpu_torch import cli
    from tracs_tpu_torch.ops import kernels

    kernels.SPLIT_GRAM_LAUNCHES = kernels.POPCOUNT_GRAM_LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(argv + ["--device", device.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.SPLIT_GRAM_LAUNCHES
    n_blocks = -(-n // row_block)
    print(f"# {what}: {wall:.3f} s wall, split_gram launches {launches} for "
          f"{n_blocks} row blocks, popcount_gram launches {kernels.POPCOUNT_GRAM_LAUNCHES}")
    if launches != n_blocks:
        fail(f"{what}: {launches} split_gram launches for {n_blocks} row blocks")
    with open(argv[argv.index("-o") + 1], "rb") as fh:
        data = fh.read()
    fields = [ln.split(",") for ln in data.decode().splitlines()[1:]]
    return wall, launches, fields, hashlib.sha256(data).hexdigest()


def phase_slice(packed, fasta: str, cluster_size: int, row_block: int, seed: int, tmp: str,
                device):
    """The distance stage through the CLI entry point; returns (split_gram
    launches, CSV rows)."""
    n, L = packed.n_seqs, packed.length
    out = os.path.join(tmp, "dists.csv")
    argv = ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block", str(row_block)]
    wall, launches, fields, sha = _run_cli(argv, n, row_block, "distance CLI", device)
    i = np.array([int(f[0]) for f in fields], dtype=np.int64)
    j = np.array([int(f[1]) for f in fields], dtype=np.int64)
    sizes = np.bincount(np.arange(n) // cluster_size)
    expected = int((sizes * (sizes - 1) // 2).sum())
    pairs = n * (n - 1) // 2
    print(f"# CSV: {len(fields)} rows (within-cluster pairs: {expected}), sha256 {sha}")
    print(f"# slice: {pairs / wall:,.0f} pairs/s over the CLI wall time ({pairs} pairs)")
    if len(fields) != expected or not np.all(i // cluster_size == j // cluster_size):
        fail("the CSV does not hold exactly the within-cluster pairs")
    if not np.all(i < j):
        fail("the CSV holds pairs outside the upper triangle")

    rng = np.random.default_rng(seed)
    pick = rng.choice(len(fields), size=min(2000, len(fields)), replace=False)
    d_csv = np.array([int(fields[k][3]) for k in pick])
    nn_csv = np.array([int(fields[k][7]) for k in pick])
    d_ref, nn_ref = oracle(packed.planes, L, i[pick], j[pick])
    if not (np.array_equal(d_csv, d_ref) and np.array_equal(nn_csv, nn_ref)):
        fail("sampled CSV rows disagree with the host popcount oracle")
    print(f"# oracle: {len(pick)} sampled rows agree (SNP distance and sites considered)")
    return launches, fields


def phase_sweeps(fasta: str, row_block: int, device):
    """pairsnp_stream through both engines, cold (fresh alignment object:
    compaction scan, layout and upload) and warm (resident), the warm runs
    taken in turns.  The popcount run is the popcount engine's main path:
    its launch count is read around its cold sweep.  Returns that count."""
    import torch

    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.packing import PackedAlignment, pack_fasta
    from tracs_tpu_torch.ops.pairsnp import pairsnp_stream

    t0 = time.perf_counter()
    packed = pack_fasta(fasta)
    print(f"# pack_fasta: {time.perf_counter() - t0:.3f} s")
    n_blocks = -(-packed.n_seqs // row_block)

    def sweep(p, method):
        t0 = time.perf_counter()
        blocks = list(pairsnp_stream([p], dist=200, row_block=row_block, device=device,
                                     method=method))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, blocks

    fresh = {m: PackedAlignment(packed.planes, packed.length, packed.names)
             for m in ("split", "popcount")}
    t_split, split_blocks = sweep(fresh["split"], "split")
    kernels.SPLIT_GRAM_LAUNCHES = kernels.POPCOUNT_GRAM_LAUNCHES = 0
    t_pc, pc_blocks = sweep(fresh["popcount"], "popcount")
    launches = kernels.POPCOUNT_GRAM_LAUNCHES
    print(f"# sweep cold (layout + upload): split {t_split:.3f} s, popcount {t_pc:.3f} s; "
          f"popcount_gram launches {launches}, split_gram launches "
          f"{kernels.SPLIT_GRAM_LAUNCHES} for {n_blocks} row blocks")
    if launches != n_blocks or kernels.SPLIT_GRAM_LAUNCHES:
        fail(f"the popcount sweep made {launches} popcount_gram launches for {n_blocks} "
             f"row blocks and {kernels.SPLIT_GRAM_LAUNCHES} split_gram launches")
    if len(pc_blocks) != len(split_blocks):
        fail("the popcount and split sweeps yield different numbers of blocks")
    for bp, bs in zip(pc_blocks, split_blocks):
        if bp[:2] != bs[:2] or not all(np.array_equal(x, y) for x, y in zip(bp[3:], bs[3:])):
            fail(f"the popcount sweep disagrees with the split sweep at rows [{bs[0]}, {bs[1]})")
    rows = sum(len(b[3]) for b in pc_blocks)
    print(f"# popcount sweep == split sweep, array for array: {len(pc_blocks)} blocks, "
          f"{rows} pairs")
    warm = {"split": [], "popcount": []}
    for method in ("split", "popcount", "popcount", "split", "split", "popcount"):
        warm[method].append(sweep(fresh[method], method)[0])
    for method, ts in warm.items():
        print(f"# sweep warm {method}: median {float(np.median(ts)):.4f} s of "
              f"{', '.join(f'{t:.4f}' for t in ts)}")
    return launches


def write_dates(path: str, n: int, cluster_size: int, seed: int) -> None:
    """Seeded metadata CSV of the headline workload: each cluster gets a base
    date in 2019-2021, and each member is dated 0-180 days after it."""
    from datetime import date, timedelta

    rng = np.random.default_rng(seed + 2)
    n_clusters = -(-n // cluster_size)
    base = rng.integers(0, 3 * 365, size=n_clusters)
    offset = rng.integers(0, 181, size=n)
    with open(path, "w") as fh:
        fh.write("name,date\n")
        for i in range(n):
            day = date(2019, 1, 1) + timedelta(days=int(base[i // cluster_size] + offset[i]))
            fh.write(f"{i},{day.isoformat()}\n")


def phase_meta(packed, fasta: str, cluster_size: int, row_block: int, seed: int,
               tmp: str, plain_fields, device):
    """``distance --meta`` through the CLI on the card; returns (wall s,
    split_gram launches, the run's (N, delta) columns)."""
    from tracs_tpu_torch.models.transcluster import lprob_k_given_N, trans_dist

    n = packed.n_seqs
    dates = os.path.join(tmp, "dates.csv")
    write_dates(dates, n, cluster_size, seed)
    out = os.path.join(tmp, "dists_meta.csv")
    argv = ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block", str(row_block),
            "--meta", dates]
    wall, launches, fields, sha = _run_cli(argv, n, row_block, "distance --meta CLI", device)
    print(f"# --meta CSV: {len(fields)} rows, sha256 {sha}")
    if [f[:2] for f in fields] != [f[:2] for f in plain_fields]:
        fail("the --meta run's rows differ from the run without --meta")
    if [f[3] for f in fields] != [f[3] for f in plain_fields]:
        fail("the --meta run's SNP distances differ from the run without --meta")
    N = np.array([int(f[3]) for f in fields], dtype=np.int64)
    years = np.array([float(f[2]) for f in fields])
    p0 = np.array([float(f[4]) for f in fields])
    eK = np.array([float(f[5]) for f in fields])
    if not (np.all((p0 >= 0) & (p0 <= 1)) and np.all(np.isfinite(eK) & (eK >= 0))):
        fail("a p0 outside [0, 1] or an E(K) that is not finite and >= 0")
    if any(f[6] != "NA" for f in fields):
        fail("the filtered column is not NA on a --meta run")

    rng = np.random.default_rng(seed + 3)
    pick = rng.choice(len(fields), size=min(2000, len(fields)), replace=False)
    # the reference's table lgamma[i] = lgamma(i); entry 0 (a pole) is never read
    lgamma = [math.inf] + [math.lgamma(i) for i in range(1, int(N.max()) + 3)]
    lp_scalar = np.array([lprob_k_given_N(N[k], 0, years[k], LAMB, BETA, lgamma)[0]
                          for k in pick])
    err_scalar = float(np.max(np.abs(np.log(p0[pick]) - lp_scalar) / np.maximum(1, np.abs(lp_scalar))))
    lp_cpu, ek_cpu = trans_dist(N[pick], years[pick], LAMB, BETA, PRECISION, device="cpu")
    err_p0 = float(np.max(np.abs(p0[pick] - np.exp(lp_cpu)) / np.abs(np.exp(lp_cpu))))
    err_ek = float(np.max(np.abs(eK[pick] - ek_cpu) / np.maximum(np.abs(ek_cpu), 1e-300)))
    print(f"# --meta sampled rows ({len(pick)}): log p0 vs scalar lprob_k_given_N rel err "
          f"{err_scalar:.3e}; p0 vs CPU model {err_p0:.3e}, E(K) vs CPU model {err_ek:.3e}")
    if max(err_scalar, err_p0, err_ek) > 1e-9:
        fail("sampled --meta rows disagree with the scalar model or the CPU model at 1e-9")
    return wall, launches, N, years


def phase_trans_dist(N, years, device):
    """trans_dist alone on the card over the run's pairs (every (N, delta)
    lane new), and the reference goldens on the card at 1e-6."""
    import torch

    from tracs_tpu_torch.models.transcluster import trans_dist

    lanes = len(np.unique(np.stack([N, years], axis=1), axis=0))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        trans_dist(N, years, LAMB, BETA, PRECISION, device=device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"# trans_dist on the card: {len(N)} pairs, {lanes} unique (N, delta) lanes, "
          f"{', '.join(f'{t:.4f}' for t in times)} s (median {float(np.median(times)):.4f} s)")
    day = 86400 / 31556952
    p0, eK = trans_dist([0, 2], [day, day], 29.903, 73.0, 0.01, device=device)
    want_p0 = [0.23794988406662973, 0.024467137572328577]
    want_ek = [2.6335200453700187, 7.315670110063259]
    err = max(np.max(np.abs(np.exp(p0) - want_p0)), np.max(np.abs(eK - want_ek)))
    print(f"# trans_dist reference goldens on the card: max |err| {err:.3e}")
    if not err < 1e-6:
        fail("trans_dist misses the reference goldens on the card")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096, help="samples (default 4096)")
    ap.add_argument("--length", type=int, default=1_000_000, help="sites (default 1 Mb)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tracs_tpu_torch.runtime.build import build_cuda_library

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# card: {smi}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    def build(name):
        t0 = time.perf_counter()
        path, log = build_cuda_library(name)
        return time.perf_counter() - t0, path, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(build, KERNELS)))
    print(f"# built {len(KERNELS)} kernels in parallel: {time.perf_counter() - t0:.2f} s")
    for name, (secs, path, log) in builds.items():
        print(f"# build {name}.cu: {secs:.2f} s -> {os.path.relpath(path)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"#   {line.strip()}")

    errs = phase_kernels(device, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        packed, fasta, cluster_size = _headline(args.n, args.length, args.seed, tmp)
        split_launches, fields = phase_slice(packed, fasta, cluster_size, ROW_BLOCK,
                                             args.seed, tmp, device)
        pc_launches = phase_sweeps(fasta, ROW_BLOCK, device)
        _, _, N, years = phase_meta(packed, fasta, cluster_size, ROW_BLOCK, args.seed, tmp,
                                    fields, device)
    phase_trans_dist(N, years, device)

    def entry(name, kernel, replaces, launches, outputs):
        out_errs, ms, plain_ms = errs[kernel]
        return {"name": name, "route": "cuda", "source": f"tracs_tpu_torch/csrc/{kernel}.cu",
                "replaces": f"tracs_tpu/ops/pallas_kernels.py:{replaces}",
                "launches": launches, "max_abs_err": max(out_errs[k] for k in outputs),
                "ms": ms, "plain_ms": plain_ms}

    # K2 and K3 are one fused kernel: both entries carry its launch count and
    # time, each with the error of its own output (matches, nunion)
    print(json.dumps({"kernels": [
        entry("split_gram", "split_gram", 157, split_launches, (0, 1)),
        entry("popcount_gram (K2 matches)", "popcount_gram", 45, pc_launches, (0,)),
        entry("popcount_gram (K3 nunion)", "popcount_gram", 65, pc_launches, (1,)),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
