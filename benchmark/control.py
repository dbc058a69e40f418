"""The control of a cell's ``correct``: the plain reference put in the
program's place, computed one step below what the configuration states, and
held to the cell's limits by the same comparison as a run.  It has to come
out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

A sweep cell's outputs are exact integers and state no precision; its
control breaks the guarantee that a partial IUPAC code matches once a site:
it counts every shared allele bit (the correction gram left out).  A job
cell's control computes the date difference, p0 and E(K) in float32 where
the configuration states float64.  Prints one JSON line a seed.  Runs on the
card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, generate  # noqa: E402
from benchmark.harness import Cell  # noqa: E402


def control(cell: Cell, seed: int, device, overrides=None) -> dict:
    """{name: {value, limit}} of the control's numbers for one seed."""
    cfg = dict(cell.config, **(overrides or {}))
    traffic = cell.traffic
    planes = generate.alignment(cfg, seed)
    meta, filtered = traffic.get("meta", False), traffic.get("filter", False)
    days = generate.sample_days(cfg["samples"], cfg["cluster_size"], seed) if meta else None
    exp = check.Expected(cfg, planes, days, device, filtered=filtered)
    if traffic["unit"] == "sweep":
        low = check.Expected(cfg, planes, None, device, partial_correction=False)
        values = check.sweep_checks([(low.rows, low.cols, low.d, low.nn)], exp)
    else:
        low = check.Expected(cfg, planes, days, device, filtered=filtered, dtype=np.float32)
        values = check.job_checks([check.job_columns(low, cfg["name"], meta, filtered)], exp,
                                  cfg["name"], meta, filtered)
    return {k: {"value": v, "limit": traffic["limits"][k]} for k, v in values.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control(cell, seed, torch.device("cuda"))
        fails = any(c["value"] > c["limit"] for c in checks.values())
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": not fails,
                          "seconds": time.perf_counter() - t0, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
