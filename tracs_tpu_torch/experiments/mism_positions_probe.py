"""The mismatch-position kernels at the main path's block: the two
designs of ``csrc/mism_positions.cu`` side by side.

Builds the headline workload (``make_clustered`` at n x L, clusters of
``max(6, round(0.005 n) + 1)``), takes the pairs its first row block emits
under a SNP threshold of 200 (what ``ops/recomb.py::filter_pairs`` hands the
kernel), and on the layouts the sweep left resident (the split layout and the
raw planes) times

* the tiled kernel, the design on the path (``csrc/mism_positions.cu``,
  ``ops/kernels.py::mismatch_positions_kernel`` forced onto it: tiles of
  pairs that stage each of their samples' rows once, the word axis cut into
  parts across the card),
* the warp kernel, the first version (the same source: one warp a pair,
  straight from the resident layout).

The two are timed in turns (tiled, warp, warp, tiled), each a call
(CUDA events around the wrapper, its host part included) and on the card
alone (launches of one prepared launcher queued behind a spin), with the
host part (the tile plan) timed apart.  ``--patterns`` times the same two,
in turns, on the pair lists other callers send at the block's layout: pairs
in no order, a handful, one, one sample against many, every sample against
itself, whole rows against every later sample (``filter=True`` with no
threshold), and a query layout against the database by cluster
(``--msa-db``); beside each, the samples its tiles stage a pair and which
kernel the wrapper's rule takes.  ``--samples`` times the tiled kernel on
plans of fewer samples a tile (at most ``MISM_TILE_SAMPLES``, the kernel's
``kTileSamples``), ``--tiled-warps`` rewritten copies of the source with
other numbers of warps a block and blocks an SM, and ``--tiled-parts``
copies whose kernel does only its copies, only its pairs, or its pairs
without ranks.  Every run must equal the plain version's table.  A tool for
PERF.md: nothing in the port calls it.

Run: python -m tracs_tpu_torch.experiments.mism_positions_probe [--patterns]
    [--samples 14,24] [--tiled-parts] [--tiled-warps 16,8x2]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tracs_tpu_torch.experiments.workload import make_clustered
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops.pairsnp import (_cached_compact, _planes_device, _split_device,
                                         _split_pair, pairsnp_stream)
from tracs_tpu_torch.runtime.build import CSRC_DIR, NVCC_FLAGS, nvcc_path
from tracs_tpu_torch.runtime.device import resolve_device


def _median_ms(fn, reps: int = 10) -> float:
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


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"the kernel source no longer holds {old!r}: bring this script up to date")
    return src.replace(old, new)


def _alone_ms(launch, reps: int = 20) -> float:
    """Milliseconds of the card's own work a launch: ``reps`` launches of a
    prepared launcher queued behind a spin of ~10 ms on the card, so that
    the host's time to queue them is hidden."""
    if launch() != 0:
        sys.exit("mism_positions_probe: a launch failed")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _design(name, args, want):
    """(ms a call, ms on the card alone) of one kernel of the committed
    source, forced, after checking its table."""
    if not torch.equal(kernels.mismatch_positions_kernel(*args, _design=name), want):
        sys.exit(f"mism_positions_probe: the {name} kernel disagrees with the plain version")
    call = _median_ms(lambda: kernels.mismatch_positions_kernel(*args, _design=name))
    alone = _alone_ms(kernels._mism_launcher(*args, design=name)[2])
    return call, alone


def _rule_ms(args, reps: int = 5) -> float:
    """Host ms of the wrapper's rule on these inputs (``mism_design``: the
    tile plan included)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        kernels.mism_design((args[0],), args[0].shape[2], args[2], args[3], args[5], True)
    return (time.perf_counter() - t0) / reps * 1e3


_CHUNK = "      chunk_pairs(ring + st * stage_words, c0 + i, direct);"
_REFILL = "      if (warp == 0 && i >= 1 && i - 1 + stages < n) load("
_FULL = "      mbar_wait(full(st), (g / stages) & 1);"
_AGAIN = "    walk(n, true);"
_EMIT = "      if (hit) emit(q, m, w0, hit, direct);"


def tiled_parts(src: str) -> dict[str, str]:
    """name -> rewritten source of ``mism_positions.cu`` whose tiled kernel
    does part of its work (its table means nothing, and no block walks its
    part twice): the copies alone (no pair is read), the pairs alone (on
    whatever the first ``stages`` chunks left in shared memory: nothing
    refills a stage, nothing waits past them), or the copies and the pairs'
    mismatch words without ranks or entries."""
    once = _swap(src, _AGAIN, "    ;")
    return {"copies only": _swap(once, _CHUNK, "      ;"),
            "pairs only": _swap(_swap(once, _REFILL, _REFILL.replace("(warp == 0", "(false")),
                                _FULL, "      if (i < stages) " + _FULL.lstrip()),
            "no ranks or entries": _swap(once, _EMIT, "      if (hit == 0x12345u) "
                                                      "s_running[q] = 1;")}


_TILE_WARPS = "constexpr int kTileWarps = 32;"
_RING = "constexpr int kRingBytes = 216 * 1024;"
_SAMPLES = "constexpr int kTileSamples = 28;"
_BOUNDS = "__launch_bounds__(kTileThreads, 1)"


def tiled_warps(src: str, shapes) -> dict[str, tuple[str, int]]:
    """name -> (rewritten source of ``mism_positions.cu``, samples a tile it
    takes) whose tiled kernel runs ``warps`` warps a block and ``blocks``
    blocks an SM, for each (warps, blocks): each block gets 1 / blocks of
    the ring's shared memory and tiles of the samples whose chunks fit it
    three times."""
    out = {}
    for warps, blocks in shapes:
        text = _swap(src, _TILE_WARPS, f"constexpr int kTileWarps = {warps};")
        samples = kernels.MISM_TILE_SAMPLES
        if blocks > 1:
            ring = (216 // blocks - 2) * 1024
            samples = min(samples, ring // (3 * 5 * kernels.MISM_CHUNK_WORDS * 4))
            text = _swap(_swap(_swap(text, _RING, f"constexpr int kRingBytes = {ring};"),
                               _SAMPLES, f"constexpr int kTileSamples = {samples};"),
                         _BOUNDS, f"__launch_bounds__(kTileThreads, {blocks})")
        out[f"{warps} warps x {blocks} blocks an SM"] = (text, samples)
    return out


def _build_tiled(variants: dict, tmp: str) -> dict:
    """name -> the tiled entry point of each rewritten source, built in
    parallel."""
    procs = {}
    for k, (name, text) in enumerate(variants.items()):
        cu, so = os.path.join(tmp, f"t{k}.cu"), os.path.join(tmp, f"t{k}.so")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"mism_positions_probe: building the {name} copy failed:\n{log[-3000:]}")
        fn = ctypes.CDLL(so).tracs_mism_positions_tiled
        fn.restype, fn.argtypes = ctypes.c_int, kernels._MISM_TILED_ARGTYPES
        entries[name] = fn
    return entries


def run_tiled_warps(args, want, shapes, samples) -> None:
    """Builds the tiled kernel at other (warps a block, blocks an SM) and
    times each in turns, exact against the plain version, at every tile size
    of ``samples`` (at most what each copy takes)."""
    with open(os.path.join(CSRC_DIR, "mism_positions.cu")) as fh:
        variants = tiled_warps(fh.read(), shapes)
    pa, _, ii, jj, L, cap, ma, _ = args
    with tempfile.TemporaryDirectory() as tmp:
        entries = _build_tiled({name: text for name, (text, _) in variants.items()}, tmp)
        for tile in samples:
            runs = {}
            for name, fn in entries.items():
                plan = kernels.mism_tile_plan(ii, jj, samples=min(tile, variants[name][1]))
                out = torch.empty_like(want)
                runs[name] = (out, kernels._mism_tiled_launcher(pa, pa, ma, ma, plan, L, cap, out,
                                                                fn=fn), plan.max_samples)
            # in turns: every variant, then every variant again in reverse
            times = {name: [] for name in runs}
            for name in list(runs) + list(reversed(runs)):
                times[name].append(_alone_ms(runs[name][1]))
            for name, (out, _, held) in runs.items():
                if not torch.equal(out, want):
                    sys.exit(f"mism_positions_probe: {name} disagrees with the plain version")
                print(f"tiled kernel, {name}, {held} samples a tile, split layout: on the card "
                      f"alone {', '.join(f'{t:.4f}' for t in times[name])} ms [OK]", flush=True)


def run_tiled_parts(args, want) -> None:
    """Builds the tiled kernel's parts and times each beside the whole
    kernel on the card alone, in turns."""
    with open(os.path.join(CSRC_DIR, "mism_positions.cu")) as fh:
        variants = tiled_parts(fh.read())
    pa, _, ii, jj, L, cap, ma, _ = args
    out, _, whole = kernels._mism_launcher(*args, design="tiled")
    plan = kernels.mism_tile_plan(ii, jj)
    with tempfile.TemporaryDirectory() as tmp:
        launchers = {"whole kernel": whole}
        for name, fn in _build_tiled(variants, tmp).items():
            part_out = torch.empty_like(out)
            launchers[name] = kernels._mism_tiled_launcher(pa, pa, ma, ma, plan, L, cap,
                                                           part_out, fn=fn)
        times = {name: [] for name in launchers}
        for name in list(launchers) + list(reversed(launchers)):
            times[name].append(_alone_ms(launchers[name]))
        if not torch.equal(out, want):
            sys.exit("mism_positions_probe: the tiled kernel disagrees with the plain version")
        for name, ms in times.items():
            print(f"tiled kernel, {name}, split layout: on the card alone "
                  f"{', '.join(f'{t:.4f}' for t in ms)} ms", flush=True)


def pattern_lists(rows: np.ndarray, cols: np.ndarray, n: int, seed: int = 7) -> dict:
    """name -> (ii, jj, query rows or None) of the pair lists ``--patterns``
    times, over ``n`` samples whose clusters the block's (rows, cols) give.
    With query rows, A is a layout of its own holding those samples (the
    query side of ``--msa-db``), B the whole one."""
    rng = np.random.default_rng(seed)
    P = len(rows)
    lists = {
        "pairs in no order, as many as block 0": (rng.integers(0, n, P), rng.integers(0, n, P)),
        "pairs in no order, 333": (rng.integers(0, n, 333), rng.integers(0, n, 333)),
        "a handful (8 pairs in no order)": (rng.integers(0, n, 8), rng.integers(0, n, 8)),
        "one pair": (np.array([3]), np.array([n - 1])),
        "one sample against 600 others": (np.full(600, 2), rng.integers(0, n, 600)),
        "every sample against itself": (np.arange(n), np.arange(n)),
    }
    first = np.concatenate([np.full(n - 1 - i, i) for i in range(4)])
    lists["rows 0-3 against every later sample"] = (
        first, np.concatenate([np.arange(i + 1, n) for i in range(4)]))
    # each query's database partners: its cluster as the block's pairs give it
    queries = 256
    mates = [np.unique(np.concatenate([[q], cols[rows == q], rows[cols == q]]))
             for q in range(queries)]
    lists[f"{queries} queries against the database by cluster (two layouts)"] = (
        np.concatenate([np.full(len(m), q) for q, m in enumerate(mates)]),
        np.concatenate(mates), queries)
    return {k: v if len(v) == 3 else (*v, None) for k, v in lists.items()}


def run_patterns(ea, nm, rows, cols, L: int, cap: int) -> None:
    """Both kernels of the committed source in turns on every list of
    ``pattern_lists`` through the split layout, exact against the plain
    version, with the samples the tiles stage a pair and the rule's pick."""
    for name, (ii, jj, queries) in pattern_lists(rows, cols, ea.shape[0]).items():
        if queries is None:
            args, one = (ea, None, ii, jj, L, cap, nm, None), True
        else:
            args, one = (ea[:queries].clone(), ea, ii, jj, L, cap, nm[:queries].clone(), nm), False
        want = kernels.mismatch_positions_reference(*args)
        plan = kernels.mism_tile_plan(ii, jj, one_layout=one)
        rule, _ = kernels.mism_design(tuple(t for t in args if isinstance(t, torch.Tensor)),
                                      ea.shape[2], ii, jj, cap, one)
        times = {"tiled": [], "warp": []}
        for who in ("tiled", "warp", "warp", "tiled"):
            times[who].append(_design(who, args, want))
        print(f"pattern {name}: {len(ii)} pairs, {plan.tiles} tiles staging "
              f"{len(plan.keys) / len(ii):.3f} samples a pair, the rule takes the {rule} kernel; "
              + "; ".join(f"{who}: a call {', '.join(f'{c:.3f}' for c, _ in r)} ms, on the card "
                          f"alone {', '.join(f'{a:.4f}' for _, a in r)} ms"
                          for who, r in times.items()) + " [OK]", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--length", type=int, default=1_000_000)
    ap.add_argument("--row-block", type=int, default=1024)
    ap.add_argument("--patterns", action="store_true",
                    help="time both committed kernels on other callers' pair lists")
    ap.add_argument("--samples", default="",
                    help="fewer samples a tile of the tiled kernel to time besides the "
                         f"default ({kernels.MISM_TILE_SAMPLES})")
    ap.add_argument("--tiled-parts", action="store_true",
                    help="time the tiled kernel's copies alone and its pairs alone")
    ap.add_argument("--tiled-warps", default="",
                    help="warps a block of the tiled kernel, each as W or WxB (B blocks an "
                         "SM), to build and time at every --samples tile size (and the default)")
    args = ap.parse_args(argv)
    samples = [int(x) for x in args.samples.split(",") if x]
    if any(not 2 <= x <= kernels.MISM_TILE_SAMPLES for x in samples):
        ap.error(f"--samples: tiles of 2 to {kernels.MISM_TILE_SAMPLES} samples")
    device = resolve_device("cuda")
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    packed = make_clustered(args.n, args.length,
                            cluster_size=max(6, round(0.005 * args.n) + 1))
    block = next(iter(pairsnp_stream([packed], dist=200, row_block=args.row_block,
                                     device=device)))
    rows, cols, dvals = block[3], block[4], block[5]
    todo = dvals > 1
    rows, cols = rows[todo], cols[todo]
    cap = 1 << max(7, int(np.ceil(np.log2(max(2, int(dvals.max()))))))
    comp = _cached_compact(packed, packed)
    a_k = packed if comp is None else comp[0]
    ea, nm, _ = _split_device(_split_pair(a_k, None, device)[0], device)
    raw = _planes_device(a_k, device)
    L, W, P = a_k.length, ea.shape[2], len(rows)
    used = len(np.unique(np.concatenate([rows, cols])))
    plan = kernels.mism_tile_plan(rows, cols)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shape = kernels.mism_launch_shape(plan, L, sms, cap)
    print(f"# block 0: {P} pairs over {used} distinct samples, W={W}, capacity {cap}; "
          f"{plan.tiles} tiles of at most {kernels.MISM_TILE_SAMPLES} samples stage "
          f"{len(plan.keys)} ({len(plan.keys) / P:.3f} a pair); "
          f"{kernels.MISM_CHUNK_WORDS} words a chunk, {shape.parts} parts of {shape.part_chunks} "
          f"chunks, {plan.tiles * shape.parts} blocks", flush=True)

    # the pair indices as the filter passes them: numpy on the host
    layouts = {"split layout": (ea, None, rows, cols, L, cap, nm, None),
               "raw planes": (raw, None, rows, cols, L, cap)}
    want = {name: kernels.mismatch_positions_reference(*a) for name, a in layouts.items()}
    for name, a in layouts.items():
        planes, mask = a[0], (a[6] if len(a) == 8 else None)
        # the two committed designs in turns
        times = {"tiled": [], "warp": []}
        for who in ("tiled", "warp", "warp", "tiled"):
            times[who].append(_design(who, a, want[name]))
        for who, runs in times.items():
            print(f"{name}: {who} kernel: a call "
                  f"{', '.join(f'{r[0]:.3f}' for r in runs)} ms; on the card alone "
                  f"{', '.join(f'{r[1]:.4f}' for r in runs)} ms [OK]", flush=True)
        print(f"{name}: the wrapper's rule on the host (the tile plan included) "
              f"{_rule_ms(a):.3f} ms", flush=True)
        for tile in samples:
            p = kernels.mism_tile_plan(rows, cols, samples=tile)
            res = torch.empty_like(want[name])
            launch = kernels._mism_tiled_launcher(planes, planes, mask, mask, p, L, cap, res)
            alone = _alone_ms(launch)
            if not torch.equal(res, want[name]):
                sys.exit(f"mism_positions_probe: tiles of {tile} samples, {name}: disagree "
                         f"with the plain version")
            print(f"tiled kernel, {tile:2d} samples a tile ({p.tiles} tiles, "
                  f"{len(p.keys) / P:.3f} staged a pair), {name}: on the card alone "
                  f"{alone:.4f} ms [OK]", flush=True)
    if args.patterns:
        run_patterns(ea, nm, rows, cols, L, cap)
    if args.tiled_parts:
        run_tiled_parts(layouts["split layout"], want["split layout"])
    if args.tiled_warps:
        shapes = [tuple(int(x) for x in (w + "x1").split("x")[:2])
                  for w in args.tiled_warps.split(",")]
        run_tiled_warps(layouts["split layout"], want["split layout"], shapes,
                        sorted({kernels.MISM_TILE_SAMPLES, *samples}))


if __name__ == "__main__":
    main()
