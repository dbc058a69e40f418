"""Variant sweep of the split-gram kernel (counterpart of the JAX package's
``scripts/kernel_experiments.py``).

Builds the headline clustered alignment, puts its split layout on the
device, and runs the main-path kernel ``split_gram`` (K1, b1 ``mma.sync`` fed
by a ``cp.async`` ring) and every tensor-core variant of
``split_gram_variant`` over the full n x n square.  Each variant's ``(g, gn)`` must equal K1's bit for bit.
Prints, per kernel, the median milliseconds of 3 runs after a warm-up (CUDA
events; the host clock on the CPU, where the plain versions run), pairs/s
and ``OK`` or ``MISMATCH``, and exits non-zero on any mismatch or launch
failure.

Run: python -m tracs_tpu_torch.experiments.kernel_experiments [n] [L] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tracs_tpu_torch.experiments.workload import make_clustered
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops.pairsnp import _cached_split, _split_device
from tracs_tpu_torch.runtime.device import resolve_device


def _median_ms(fn, device: torch.device, reps: int = 3):
    """(result of the warm-up call, median ms of ``reps`` further calls)."""
    out = fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def run(n: int, L: int, device: str | torch.device) -> list[dict]:
    """One row per kernel: ``name``, ``ms``, ``pairs_per_s``, ``ok`` (None for
    K1, the baseline the others are held against)."""
    device = resolve_device(device)
    sa = _cached_split(make_clustered(n, L), device)
    ea, nm, _ = _split_device(sa, device)
    print(f"# n={n} L={L} W={ea.shape[2]} device={device}", flush=True)

    rows = []
    (g0, gn0), ms = _median_ms(lambda: kernels.split_gram(ea, nm, 0, n, 0), device)
    rows.append({"name": "split_gram", "ms": ms, "pairs_per_s": n * n / (ms / 1e3), "ok": None})
    for dot, tile, unpack in kernels.SPLIT_GRAM_VARIANTS:
        (g, gn), ms = _median_ms(
            lambda: kernels.split_gram_variant(ea, nm, 0, n, 0, dot=dot, tile=tile,
                                               unpack=unpack), device)
        ok = bool(torch.equal(g, g0) and torch.equal(gn, gn0))
        rows.append({"name": kernels.variant_name(dot, tile, unpack), "ms": ms,
                     "pairs_per_s": n * n / (ms / 1e3), "ok": ok})
        del g, gn
    for r in rows:
        verdict = "ref" if r["ok"] is None else "OK" if r["ok"] else "MISMATCH"
        print(f"{r['name']}: sweep {r['ms']:.3f} ms, {r['pairs_per_s']:,.0f} pairs/s "
              f"[{verdict}]", flush=True)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=256, help="samples (default 256)")
    ap.add_argument("L", type=int, nargs="?", default=1_000_000, help="sites (default 1 Mb)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="default: cuda; fails when no card exists")
    args = ap.parse_args(argv)
    rows = run(args.n, args.L, args.device)
    bad = [r["name"] for r in rows if r["ok"] is False]
    if bad:
        sys.exit(f"kernel_experiments: MISMATCH against split_gram: {', '.join(bad)}")
    return rows


if __name__ == "__main__":
    main()
