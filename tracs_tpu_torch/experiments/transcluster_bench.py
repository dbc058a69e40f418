"""Transmission-model bench of the port: the E(K)/p0 engine's rate on the
north-star (N, delta) mix, timed through ``TransClusterCache.lookup`` on the
card (counterpart of the JAX package's ``scripts/transcluster_bench.py``).

    python -m tracs_tpu_torch.experiments.transcluster_bench [csv] [repeats]
        [--device cuda|cpu]

The mix is the north-star ``dists.csv``'s SNP-distance and date-difference
columns when ``csv`` exists (default ``_northstar/dists.csv``), else the
script's synthetic reconstruction: 250,000 rows from ``default_rng(11)``,
N uniform in [10, 160], dates uniform over ten years.  Each of ``repeats``
(default 3) cold runs builds a new cache with the ``distance`` stage's
defaults (clock rate 1e-3 x 29903, transmission rate 73, precision 0.01) and
looks every row up; then one repeat on the last cache, every pair memoised.
Prints the mix on stderr and ONE JSON line on stdout: the script's keys
(``metric``, ``rows``, ``unique``, ``cold_s``, ``cold_s_median``,
``unique_per_s``, ``rows_per_s_warm_memo``), then ``device`` (the card's
name, or ``cpu``).  ``--device cuda`` (the default) without a card exits 1;
nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tracs_tpu_torch.models.transcluster import TransClusterCache
from tracs_tpu_torch.runtime.device import DeviceUnavailableError, resolve_device

#: the distance stage's --clock_rate, --trans_rate and --precision defaults
LAMB, BETA, PRECISION = 1e-3 * 29903, 73.0, 0.01


def load_mix(csv_path):
    """(SNP distances, date differences in years, what they are) of the mix:
    columns 3 and 2 of the north-star CSV when it exists, else the synthetic
    reconstruction (scripts/transcluster_bench.py::load_mix)."""
    if csv_path and os.path.exists(csv_path):
        snp, dd = [], []
        with open(csv_path) as fh:
            next(fh)
            for line in fh:
                parts = line.split(",")
                dd.append(float(parts[2]))
                snp.append(int(parts[3]))
        return np.asarray(snp), np.asarray(dd), f"north-star csv ({csv_path})"
    rng = np.random.default_rng(11)
    n = 250_000
    snp = rng.integers(10, 161, size=n)
    dd = np.abs(
        rng.integers(0, 3650, size=n) - rng.integers(0, 3650, size=n)
    ) / 365.25
    return snp, dd, "synthetic reconstruction (n=250k, N~U[10,160], dates 10y)"


def bench(snp, dd, *, repeats: int = 3, device="cuda") -> dict:
    """Times ``TransClusterCache.lookup`` on the mix: ``repeats`` cold runs,
    then one all-memoised repeat.  Returns the JSON line as a dict."""
    device = resolve_device(device)
    uniq = len({(int(a), round(float(b), 12)) for a, b in zip(snp, dd)})
    print(f"# {len(snp)} rows, {uniq} unique (N, delta)", file=sys.stderr)
    times = []
    for r in range(repeats):
        cache = TransClusterCache(LAMB, BETA, PRECISION, device=device)
        t0 = time.perf_counter()
        cache.lookup(snp, dd)  # returns numpy arrays: the card's work is done
        times.append(time.perf_counter() - t0)
        print(f"# run {r} (cold cache): {times[-1]:.3f}s", file=sys.stderr)
    t0 = time.perf_counter()
    cache.lookup(snp, dd)
    warm = time.perf_counter() - t0
    med = float(np.median(times))
    return {
        "metric": "transcluster E(K)+p0 rate, north-star mix",
        "rows": len(snp), "unique": uniq,
        "cold_s": times,
        "cold_s_median": med,
        "unique_per_s": uniq / med,
        "rows_per_s_warm_memo": len(snp) / warm,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csv", nargs="?", default="_northstar/dists.csv",
                    help="north-star distance CSV (default _northstar/dists.csv; the "
                         "synthetic mix where it does not exist)")
    ap.add_argument("repeats", nargs="?", type=int, default=3, help="cold runs (default 3)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except DeviceUnavailableError as e:
        raise SystemExit(f"transcluster_bench: {e}") from e
    snp, dd, source = load_mix(args.csv)
    print(f"# mix: {len(snp)} rows — {source}", file=sys.stderr)
    print(json.dumps(bench(snp, dd, repeats=args.repeats, device=device)))


if __name__ == "__main__":
    main()
