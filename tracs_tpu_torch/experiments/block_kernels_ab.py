"""The main path's two device steps after the grams, ``partial_gram`` and
``coo_extract``, of two checkouts of this repository timed on one card in
turns (A, B, B, A by default).

Each turn runs ``block_kernels`` of its checkout's ``chip_smoke.py`` in a
process of its own: every case exact against the kernel's plain version (or
the turn fails), then the kernel's median time at each block of the main
path's sweep (rb=1024 against the column suffixes m=4096, 3072, 2048, 1024
of n=4096; 2048 partial sites) in CUDA events around each call, as phase 2
of ``chip_smoke.py`` does (the host's part of a call included).  Then, at
the first block, 20 calls of each under ``torch.profiler``: the card's own
time a call, summed over the kernels whose names carry ``partial_gram`` or
``coo_`` (a call may launch several).  So a change to either kernel is
compared with its parent on one card in one call.  Prints each turn's times
as it ends, then one JSON line: per checkout and per (kernel, block), the
median over its turns.

Run from the root of a checkout, on a machine with a CUDA card:

    python -m tracs_tpu_torch.experiments.block_kernels_ab DIR_A DIR_B [--turns ABBA]

A checkout is a directory holding ``chip_smoke.py`` (with
``block_kernels(device, seed, card)``) and its package, such as a
``git archive`` of a commit unpacked into a directory that .gitignore lists;
each builds its kernels into its own ``build/``.  A tool for PERF.md:
nothing in the port calls it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

#: what a turn runs, from the root of its checkout
_TURN = r"""
import subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
props = torch.cuda.get_device_properties(0)
mhz = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
    capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
chip_smoke.block_kernels(torch.device("cuda", 0), 0,
                         {"sms": props.multi_processor_count, "sm_hz": mhz * 1e6})

from torch.profiler import ProfilerActivity, profile
from tracs_tpu_torch.ops import kernels as K
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(7)
def ints(lo, hi, *shape):
    return torch.randint(lo, hi, shape, dtype=torch.int32, device=dev, generator=gen)
pt, L = ints(-2**31, 2**31 - 1, 4096, 4, 64), 1_000_000
cnt_a, cnt_b, gp = ints(0, 1000, 1024), ints(0, 1000, 4096), ints(-64, 1, 1024, 4096)
g = L - ints(0, 40000, 1024, 4096) - cnt_a[:, None] - cnt_b[None, :] - gp
gn = ints(0, L // 2, 1024, 4096)
kw = dict(mode="split", L=L, dist=200, r0=0, c0=0, n_valid=4096, triangle=True, gp=gp,
          cnt_a=cnt_a, cnt_b=cnt_b)
for _ in range(3):
    K.partial_gram(pt[:1024], pt)
    K.coo_extract(g, gn, **kw)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(20):
        K.partial_gram(pt[:1024], pt)
    for _ in range(20):
        K.coo_extract(g, gn, **kw)
    torch.cuda.synchronize()
for e in prof.key_averages():
    t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    if t:
        print(f"PROF {e.count} {t / 1e3} {e.key}")
"""

#: a timed line of ``block_kernels``: "# <kernel> at <block>: kernel <ms> ms"
_TIMED = re.compile(r"^# (partial_gram|coo_extract(?: \(\w+\))?) at ([^:]+): kernel ([0-9.]+) ms")


def run_turn(tree: str, timeout: float) -> dict:
    """{(kernel, block): ms} of one turn in checkout ``tree``."""
    r = subprocess.run([sys.executable, "-c", _TURN], cwd=tree, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise SystemExit(f"block_kernels failed in {tree} (rc {r.returncode}):\n"
                         f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    times = {}
    device = {"partial_gram": 0.0, "coo_extract": 0.0}
    for line in r.stdout.splitlines():
        m = _TIMED.match(line)
        if m:
            times[f"{m.group(1)} at {m.group(2)}"] = float(m.group(3))
            if "alone" in line or "registers" in line:
                print(f"#   {os.path.basename(tree)}: {line[2:]}")
        elif line.startswith("PROF "):
            _, _count, total_ms, name = line.split(" ", 3)
            print(f"#   {os.path.basename(tree)} profiler: {name[:90]}: {total_ms} ms in all")
            for family, key in (("partial_gram", "partial_gram"), ("coo_extract", "coo_")):
                if key in name:
                    device[family] += float(total_ms) / 20
    for family, ms in device.items():
        times[f"{family} at the first block, the card's own time a call"] = ms
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (e.g. the parent commit)")
    ap.add_argument("b", help="checkout B (e.g. this one)")
    ap.add_argument("--turns", default="ABBA", help="the order of the turns (default ABBA)")
    ap.add_argument("--timeout", type=float, default=900, help="seconds a turn may take")
    args = ap.parse_args(argv)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"# card: {smi}")
    runs = {"A": [], "B": []}
    for k, side in enumerate(args.turns):
        times = run_turn(trees[side], args.timeout)
        runs[side].append(times)
        for name, ms in times.items():
            print(f"# turn {k} ({side}, {trees[side]}): {name}: {ms:.4f} ms")
    summary = {side: {name: statistics.median(t[name] for t in turns)
                      for name in turns[0]} for side, turns in runs.items() if turns}
    print(json.dumps({"card": smi, "trees": trees, "turns": args.turns, "median_ms": summary}))


if __name__ == "__main__":
    main()
