#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tracs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each one passes or the script exits non-zero):

0. the card's name and power limit, from nvidia-smi;
1. the build of every kernel of the distance path from the sources in the
   checkout (nvcc, sm_90a), with its seconds and ptxas report;
2. each kernel against its plain PyTorch version on the card, exact equality,
   at a ragged shape, a rectangle with r0 > 0 and c0 > 0, and the main-path
   shape rb=1024 x n=4096 x W=31250, with the median ms of both;
3. the distance slice through the normal entry point
   (``tracs_tpu_torch.cli.main(["distance", ...])``) on the headline
   workload: n=4096 samples x 1 Mb in clusters of 21, 2048 partial-IUPAC
   columns, seed 0, written as an uncompressed FASTA in a temp dir.  Checks
   that every row block launched the gram kernel, that the CSV holds exactly
   the within-cluster pairs, and that 2,000 sampled rows agree with a host
   numpy popcount over the raw planes.  Prints wall seconds, pairs/s and the
   CSV's sha256, then times the sweep alone.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: row block of the distance run: the JAX package's headline setting
ROW_BLOCK = 1024


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


def phase_kernels(device, seed: int):
    """split_gram against split_gram_reference on the card; returns
    (max_abs_err, kernel ms, plain ms) at the main-path shape."""
    import torch

    from tracs_tpu_torch.ops import kernels

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=device,
                             generator=gen)

    cases = [
        # name, A rows, B rows (None: self), W, r0, rb, c0
        ("ragged n=37 W=17", 37, None, 17, 0, 37, 0),
        ("rectangle 37x11 r0=5 c0=3", 48, 14, 17, 5, 37, 3),
        ("main path rb=1024 n=4096 W=31250", 4096, None, 31250, 0, 1024, 0),
    ]
    max_err = 0
    ms = plain_ms = None
    for name, na, nb, W, r0, rb, c0 in cases:
        ea, nm = words(na, 4, W), words(na, W)
        eb, nmb = (None, None) if nb is None else (words(nb, 4, W), words(nb, W))
        g, gn = kernels.split_gram(ea, nm, r0, rb, c0, eb, nmb)
        torch.cuda.synchronize()
        g0, gn0 = kernels.split_gram_reference(ea, nm, r0, rb, c0, eb, nmb)
        err = max(int((g.long() - g0.long()).abs().max()), int((gn.long() - gn0.long()).abs().max()))
        max_err = max(max_err, err)
        print(f"# kernel vs plain, {name}: out {tuple(g.shape)}, max |err| {err}")
        if err:
            fail(f"split_gram disagrees with its plain version at {name}")
        if W == 31250:
            ms = time_ms(lambda: kernels.split_gram(ea, nm, r0, rb, c0, eb, nmb), 10)
            plain_ms = time_ms(lambda: kernels.split_gram_reference(ea, nm, r0, rb, c0, eb, nmb), 3)
            print(f"# split_gram at {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median)")
        del ea, nm, eb, nmb, g, gn, g0, gn0
        torch.cuda.empty_cache()
    return max_err, ms, plain_ms


def phase_slice(n: int, L: int, row_block: int, seed: int, tmp: str):
    """The distance stage through the CLI entry point; returns the number of
    gram-kernel launches it made."""
    import torch

    from tracs_tpu_torch import cli
    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.packing import pack_fasta
    from tracs_tpu_torch.ops.pairsnp import pairsnp_stream

    cluster_size = max(6, round(0.005 * n) + 1)
    t0 = time.perf_counter()
    packed = make_clustered(n, L, cluster_size=cluster_size, seed=seed)
    fasta = os.path.join(tmp, "clustered.fasta")
    write_fasta(fasta, packed)
    print(f"# workload: n={n} L={L} clusters of {cluster_size}, FASTA "
          f"{os.path.getsize(fasta) / 1e9:.2f} GB written in {time.perf_counter() - t0:.1f} s")

    out = os.path.join(tmp, "dists.csv")
    argv = ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block", str(row_block)]
    kernels.SPLIT_GRAM_LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.SPLIT_GRAM_LAUNCHES
    n_blocks = -(-n // row_block)
    print(f"# distance CLI: {wall:.3f} s wall, split_gram launches {launches} "
          f"for {n_blocks} row blocks")
    if launches != n_blocks:
        fail(f"{launches} split_gram launches for {n_blocks} row blocks")

    with open(out, "rb") as fh:
        data = fh.read()
    sha = hashlib.sha256(data).hexdigest()
    lines = data.decode().splitlines()
    fields = [ln.split(",") for ln in lines[1:]]
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

    # where the time went: ingest, then the sweep alone, cold and warm
    t0 = time.perf_counter()
    again = pack_fasta(fasta)
    t_pack = time.perf_counter() - t0
    for label in ("cold (split + upload)", "warm (layout cached)"):
        t0 = time.perf_counter()
        rows = sum(len(blk[3]) for blk in pairsnp_stream(
            [again], dist=200, row_block=row_block, device=torch.device("cuda")))
        torch.cuda.synchronize()
        print(f"# sweep {label}: {time.perf_counter() - t0:.3f} s, {rows} pairs")
    print(f"# pack_fasta: {t_pack:.3f} s")
    return launches


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

    t0 = time.perf_counter()
    path, log = build_cuda_library("split_gram")
    print(f"# build split_gram.cu: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"#   {line.strip()}")

    max_err, ms, plain_ms = phase_kernels(device, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(args.n, args.length, ROW_BLOCK, args.seed, tmp)

    print(json.dumps({"kernels": [{
        "name": "split_gram",
        "route": "cuda",
        "source": "tracs_tpu_torch/csrc/split_gram.cu",
        "replaces": "tracs_tpu/ops/pallas_kernels.py:157",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
