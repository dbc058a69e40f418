"""Headline benchmark of the port: all-pairs SNP-distance throughput on one
card, the workload and timing of the JAX package's ``bench.py`` through the
port's own production unit (counterpart of ``bench.py``).

    python -m tracs_tpu_torch.experiments.bench [--n 4096] [--length 1000000]
        [--row-block R] [--method split|popcount|mxu] [--device cuda|cpu]

Workload: ``experiments/workload.make_clustered(n, L)`` with clusters of
max(6, round(0.005 n) + 1), seed 0: every within-cluster pair lies within a
SNP distance of 200 and no other, ~0.5% of the pairs.  The unit timed is what
``distance`` runs a row block: ``pairsnp_stream(dist=200, compact=False)``,
the engine's grams, the threshold and row-major compaction on the card
(``coo_extract``) and the copy of every block's survivors to the host, which
each sweep consumes.  Two untimed warm-ups (the first builds the layout,
uploads it and builds the kernels), then ``iters`` timed sweeps on the
resident layout; the headline is their median, the min beside it.

``vs_baseline`` is the rate over ``bench_cpu_reference``, bench.py's numpy
stand-in for the reference's OpenMP kernel (bit-packed AND/OR + popcount over
uint64 words), scaled by the host's cores.

``mfu`` is the port's own: the pairs the sweep computes (each row block
against the column suffix from its first row, ``swept_pairs``) times 5
bit-products a site (the split decomposition: 4 exclusive-base channels and
the N channel, counted so whichever engine runs), two operations each, over
the card's single-bit tensor-core peak ``PEAK_B1_OPS``; null on the CPU.

Prints per-sweep lines on stderr and ONE JSON line on stdout: bench.py's
``metric``, ``value`` (n^2 over the median, pairs/s), ``unit``,
``vs_baseline``, ``mfu``, ``sweep_s_median``, ``sweep_s_min``, then
``method``, ``peak_tops``, ``survivors`` and ``device`` (the card's name, or
``cpu``).  ``--device cuda`` (the default) without a card exits 1; nothing
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tracs_tpu_torch.experiments.workload import make_clustered
from tracs_tpu_torch.ops.pairsnp import pairsnp_stream
from tracs_tpu_torch.runtime.device import DeviceUnavailableError, resolve_device

METRIC = "pairwise comparisons/sec/chip (streamed all-pairs SNP dist + COO, 1Mb genomes)"
SNP_THRESHOLD = 200
#: single-bit (AND + POPC) tensor-core operations a second of one H100 SXM.
#: The data sheet names no b1 rate: a b1 instruction covers 8 times the sites
#: of the int8 one of the same shape and issues as fast, so the peak is 8 x
#: the data sheet's dense int8 1,979 TOP/s (wgmma b1 measured at 15,820 TOP/s
#: on an H100 80GB HBM3 at 700 W)
PEAK_B1_OPS = 8 * 1979e12
#: bit-products a site pair in the mfu: the split decomposition's 4
#: exclusive-base channels and its N channel
PRODUCTS_PER_SITE_PAIR = 5


def cluster_size(n: int) -> int:
    """bench.py's cluster size: within-cluster pairs stay ~0.5% at any n."""
    return max(6, round(0.005 * n) + 1)


def default_row_block(n: int) -> int:
    return max(1024, min(2048, n // 4))


def swept_pairs(n: int, row_block: int) -> int:
    """Pairs the sweep computes: each row block [r0, r0 + rb) against the
    column suffix [r0, n) (``pairsnp_stream``'s triangle blocks)."""
    return sum(min(row_block, n - r0) * (n - r0) for r0 in range(0, n, row_block))


def sweep(packed, *, row_block: int, method: str, device) -> list:
    """One pass of the stream unit, every block's survivors on the host:
    [(r0, r1, rows, cols, dvals, nn)] in emission order."""
    return [(r0, r1, rows, cols, d, nn) for r0, r1, _names, rows, cols, d, _filt, nn
            in pairsnp_stream([packed], dist=SNP_THRESHOLD, compact=False,
                              row_block=row_block, method=method, device=device)]


def _resident(packed, method: str):
    """The device layout the sweeps keep on the alignment object: the split
    layout's cache entry, or the raw planes' (popcount, mxu)."""
    if method == "split":
        return packed._split_cache._dev_cache
    return packed._dev_planes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_gpu(n: int = 4096, L: int = 1_000_000, *, packed=None, row_block: int | None = None,
              method: str = "split", device="cuda", iters: int = 5) -> dict:
    """Times the stream unit (bench.py's ``bench_tpu``) on ``device``: two
    warm-ups, then ``iters`` sweeps.  ``packed`` is a prepared headline
    alignment (``make_clustered(n, L, cluster_size(n))``), built here when
    None.  Raises if a timed sweep rebuilt the device layout.  Returns
    {rate, mfu, sweep_s (every timed sweep), survivors, pairs}."""
    device = resolve_device(device)
    if packed is None:
        packed = make_clustered(n, L, cluster_size=cluster_size(n))
    n, L = packed.n_seqs, packed.length
    row_block = default_row_block(n) if row_block is None else row_block

    def timed():
        _sync(device)
        t0 = time.perf_counter()
        blocks = sweep(packed, row_block=row_block, method=method, device=device)
        _sync(device)
        return time.perf_counter() - t0, sum(len(b[2]) for b in blocks)

    print(f"# warmup(layout+upload+build): {timed()[0]:.1f}s", file=sys.stderr)
    print(f"# warmup(settle): {timed()[0]:.3f}s", file=sys.stderr)
    resident = _resident(packed, method)
    sweep_s = []
    for k in range(iters):
        dt, survivors = timed()
        sweep_s.append(dt)
        print(f"# sweep {k} @{time.strftime('%H:%M:%S')}: {dt:.4f}s", file=sys.stderr)
    if _resident(packed, method) is not resident:
        raise RuntimeError("the device layout was rebuilt inside the timed sweeps")
    dt = float(np.median(sweep_s))
    print(f"# sweeps: median {dt:.4f}s min {min(sweep_s):.4f}s "
          f"all {[round(s, 4) for s in sweep_s]}", file=sys.stderr)
    rate = n * n / dt
    pairs = swept_pairs(n, row_block)
    # a share of the card's peak; none for a run on the CPU
    mfu = (2.0 * PRODUCTS_PER_SITE_PAIR * pairs * L / dt / PEAK_B1_OPS
           if device.type == "cuda" else None)
    print(f"# stream unit ({method}): {dt:.4f}s/sweep, {survivors} survivors "
          f"({100 * survivors / (n * (n - 1) / 2):.2f}% of pairs) -> {rate:,.0f} pairs/s, "
          f"{pairs} pairs swept"
          + ("" if mfu is None else f", MFU {100 * mfu:.2f}% of {PEAK_B1_OPS / 1e12:.0f} "
             "TOP/s b1 peak"), file=sys.stderr)
    return {"rate": rate, "mfu": mfu, "sweep_s": sweep_s, "survivors": survivors,
            "pairs": pairs}


def reference_row(planes: np.ndarray, i: int, L: int):
    """bench.py's CPU inner loop for row ``i`` over uint64 planes [n, 4, W64]:
    (SNP distances, comparable sites) of sample i against every sample,
    d = L - popcount(OR_x(a_x & b_x)), nn = L - popcount(N_i | N_j)."""
    shared = planes[i, 0][None, :] & planes[:, 0]
    shared |= planes[i, 1][None, :] & planes[:, 1]
    shared |= planes[i, 2][None, :] & planes[:, 2]
    shared |= planes[i, 3][None, :] & planes[:, 3]
    d = L - np.bitwise_count(shared).sum(axis=1)
    nmask_i = planes[i, 0] & planes[i, 1] & planes[i, 2] & planes[i, 3]
    nmask = planes[:, 0] & planes[:, 1] & planes[:, 2] & planes[:, 3]
    nn = L - np.bitwise_count(nmask_i[None, :] | nmask).sum(axis=1)
    return d, nn


def bench_cpu_reference(n_rows: int = 8, n: int = 256, L: int = 1_000_000) -> float:
    """bench.py's numpy realisation of the reference inner loop
    (pairsnp.hpp:395-421), ``n_rows`` rows against ``n`` random samples,
    scaled by ``os.cpu_count()``: pairs a second."""
    rng = np.random.default_rng(0)
    W64 = (L + 63) // 64
    planes = rng.integers(0, 2**63, size=(n, 4, W64), dtype=np.uint64)
    t0 = time.perf_counter()
    for i in range(n_rows):
        reference_row(planes, i, L)
    dt = time.perf_counter() - t0
    single_thread = n_rows * n / dt
    ncores = os.cpu_count() or 1
    rate = single_thread * ncores  # optimistic linear-scaling OpenMP stand-in
    print(f"# cpu reference: {single_thread:,.0f} pairs/s/core x {ncores} cores "
          f"= {rate:,.0f} pairs/s", file=sys.stderr)
    return rate


def run(n: int = 4096, L: int = 1_000_000, *, packed=None, row_block: int | None = None,
        method: str = "split", device="cuda", iters: int = 5) -> dict:
    """The bench's JSON line as a dict (bench.py's seven keys first)."""
    device = resolve_device(device)
    res = bench_gpu(n, L, packed=packed, row_block=row_block, method=method, device=device,
                    iters=iters)
    if packed is not None:
        n, L = packed.n_seqs, packed.length
    cpu_rate = bench_cpu_reference(n=n, L=L)
    return {
        "metric": METRIC,
        "value": res["rate"],
        "unit": "pairs/s",
        "vs_baseline": res["rate"] / cpu_rate,
        "mfu": res["mfu"],
        "sweep_s_median": float(np.median(res["sweep_s"])),
        "sweep_s_min": min(res["sweep_s"]),
        "method": method,
        "peak_tops": PEAK_B1_OPS / 1e12,
        "survivors": res["survivors"],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096, help="samples (default 4096)")
    ap.add_argument("--length", type=int, default=1_000_000, help="sites (default 1 Mb)")
    ap.add_argument("--row-block", type=int, default=None,
                    help="rows a block (default max(1024, min(2048, n // 4)))")
    ap.add_argument("--method", choices=("split", "popcount", "mxu"), default="split")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        line = run(args.n, args.length, row_block=args.row_block, method=args.method,
                   device=args.device)
    except DeviceUnavailableError as e:
        raise SystemExit(f"bench: {e}") from e
    print(json.dumps(line))


if __name__ == "__main__":
    main()
