"""The mismatch-position kernel at the main path's block, beside another
design of it: rows shared among pairs through shared memory.

Builds the headline workload (``make_clustered`` at n x L, clusters of
``max(6, round(0.005 n) + 1)``), takes the pairs its first row block emits
under a SNP threshold of 200 (what ``ops/recomb.py::filter_pairs`` hands the
kernel), and on the layouts the sweep left resident (the split layout and the
raw planes) times

* the committed kernel, ``ops/kernels.py::mismatch_positions_kernel``
  (``csrc/mism_positions.cu``: one warp a pair, straight from the resident
  layout), and
* ``csrc/mism_positions_shared.cu``, in which a block takes ``group``
  consecutive pairs and stages each distinct sample among them in shared
  memory once, for every ``--groups`` value.  For each it prints the words
  the blocks stage for every pair-word (10 without sharing), counted from the
  pair list on the host.

Every run must equal the plain version's table.  ``--parts`` builds rewritten
copies of the shared-memory source and times each through the split layout at
``--groups``: other numbers of warps a block, staging buffers and buffer
sizes, and for each the copies alone (no pair is read) and the pairs alone (on
whatever the first chunks left in shared memory: its table means nothing).
A tool for PERF.md: nothing in the port calls it.

Run: python -m tracs_tpu_torch.experiments.mism_positions_probe [--parts]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

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


def staged_words_per_pair_word(ii: np.ndarray, jj: np.ndarray, group: int, planes: int) -> float:
    """Words the kernel's blocks copy to shared memory for every word of a
    pair: ``planes`` for each distinct sample of a group of consecutive pairs,
    over the group's pairs (2 x ``planes`` when nothing is shared)."""
    staged = sum(len(np.unique(np.concatenate([ii[s:s + group], jj[s:s + group]])))
                 for s in range(0, len(ii), group))
    return planes * staged / len(ii)


_WARPS = "constexpr int kWarps = 8;"
_STAGES = "constexpr int kStages = 2;"
_STAGE = "constexpr int kStageWords = 10240;"
_MAX_GROUP = "constexpr int kMaxGroup = 128;"
_PAIRS = "    for (int q = q_begin; q < q_end; ++q) {\n      uint32_t m[4]"
_AHEAD = "    if (ahead < n_chunks) stage_chunk(static_cast<int>(ahead % kStages), ahead);"
_WAIT = "    if constexpr (VEC)\n      mbar_wait("
#: (warps a block, staging buffers, words a buffer); the first is the source's own
SHAPES = ((8, 2, 10240), (8, 3, 6400), (8, 4, 5120), (8, 2, 5120), (8, 4, 2560),
          (16, 2, 10240), (16, 2, 5120), (16, 4, 5120), (4, 2, 10240))


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"the kernel source no longer holds {old!r}: bring this script up to date")
    return src.replace(old, new)


def part_variants(src: str) -> dict[str, str]:
    """name -> source of every variant of ``mism_positions_shared.cu``; the
    first is the source as it stands.  Buffers below 5120 words hold a chunk
    of at most 64 pairs' samples, so those variants cap the group at 64."""
    out = {}
    for warps, stages, words in SHAPES:
        base = _swap(_swap(_swap(src, _WARPS, f"constexpr int kWarps = {warps};"), _STAGES,
                           f"constexpr int kStages = {stages};"), _STAGE,
                     f"constexpr int kStageWords = {words};")
        if words < 5120:
            base = _swap(base, _MAX_GROUP, "constexpr int kMaxGroup = 64;")
        name = f"{warps} warps, {stages} buffers of {words * 4 / 1024:g} KB"
        out[name + (" (as it stands)" if (warps, stages, words) == SHAPES[0] else "")] = base
        out[name + ", copies only (part)"] = _swap(base, _PAIRS, _PAIRS.replace("q < q_end", "q < 0"))
        # nothing refills a buffer and nothing waits for one past the first chunks
        out[name + ", pairs only (part)"] = _swap(
            _swap(base, _AHEAD, "    ;"), _WAIT, "    if (VEC && chunk < kStages - 1)\n      mbar_wait(")
    return out


def _build(path: str, so: str):
    """Starts nvcc on ``path`` with the build's own flags; returns a function
    that waits for it and gives the typed entry point."""
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", so, path], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def entry():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"mism_positions_probe: building {path} failed:\n{log[-3000:]}")
        fn = ctypes.CDLL(so).tracs_mism_positions_shared
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 2)
        return fn
    return entry


def _shared_call(fn, planes, mask, ii, jj, L: int, cap: int, group: int, out):
    """A launch of the shared-memory design on one layout (both sides)."""
    m = None if mask is None else mask.data_ptr()
    stream = torch.cuda.current_stream(planes.device).cuda_stream

    def call():
        rc = fn(planes.data_ptr(), m, planes.data_ptr(), m, ii.data_ptr(), jj.data_ptr(),
                len(ii), planes.shape[2], L, cap, group, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"launch failed, CUDA error {rc}")
    return call


def run_parts(src: str, groups, ea, nm, ii, jj, L: int, cap: int, want) -> None:
    """Builds every variant at once and times each at ``groups``."""
    out = torch.empty((len(ii), 1 + cap), dtype=torch.int32, device=ea.device)
    with tempfile.TemporaryDirectory() as tmp:
        entries = {}
        for k, (name, text) in enumerate(part_variants(src).items()):
            cu = os.path.join(tmp, f"v{k}.cu")
            with open(cu, "w") as fh:
                fh.write(text)
            entries[name] = (_build(cu, os.path.join(tmp, f"v{k}.so")),
                             64 if "kMaxGroup = 64;" in text else 128)
        for name, (entry, max_group) in entries.items():
            fn = entry()
            cells = []
            for group in groups:
                if group > max_group:
                    continue
                ms = _median_ms(_shared_call(fn, ea, nm, ii, jj, L, cap, group, out))
                if "(part)" not in name and not torch.equal(out, want):
                    sys.exit(f"mism_positions_probe: {name!r} at group {group} disagrees with "
                             f"the plain version")
                cells.append(f"group {group}: {ms:.3f} ms")
            print(f"{name}: {', '.join(cells)}" + ("" if "(part)" in name else " [OK]"),
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--length", type=int, default=1_000_000)
    ap.add_argument("--row-block", type=int, default=1024)
    ap.add_argument("--groups", default="32,8,16,64,128",
                    help="pairs a block of the shared-memory design; the first is timed in "
                         "turns with the committed kernel")
    ap.add_argument("--parts", action="store_true",
                    help="time rewritten copies of the shared-memory source")
    args = ap.parse_args(argv)
    groups = [int(g) for g in args.groups.split(",")]
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
    ea, nm, _ = _split_device(_split_pair(a_k, None)[0], device)
    raw = _planes_device(a_k, device)
    ii, jj = torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)
    L, W, P = a_k.length, ea.shape[2], len(rows)
    used = len(np.unique(np.concatenate([rows, cols])))
    print(f"# block 0: {P} pairs over {used} distinct samples, W={W}, capacity {cap}", flush=True)

    layouts = {"split layout": (ea, None, ii, jj, L, cap, nm, None),
               "raw planes": (raw, None, ii, jj, L, cap)}
    want = {name: kernels.mismatch_positions_reference(*a) for name, a in layouts.items()}
    shared_cu = os.path.join(CSRC_DIR, "mism_positions_shared.cu")
    with tempfile.TemporaryDirectory() as tmp:
        shared = _build(shared_cu, os.path.join(tmp, "shared.so"))()
        out = torch.empty((P, 1 + cap), dtype=torch.int32, device=device)
        for name, a in layouts.items():
            if not torch.equal(kernels.mismatch_positions_kernel(*a), want[name]):
                sys.exit(f"mism_positions_probe: {name}: the committed kernel disagrees with "
                         f"its plain version")
            planes, mask = a[0], (a[6] if len(a) == 8 else None)
            n_planes = 4 if mask is None else 5
            # the two designs in turns, the shared-memory one at its first group size
            first = _shared_call(shared, planes, mask, ii, jj, L, cap, groups[0], out)
            times = {"committed": [], "shared": []}
            for who in ("committed", "shared", "shared", "committed"):
                times[who].append(_median_ms(
                    first if who == "shared"
                    else (lambda: kernels.mismatch_positions_kernel(*a))))
            print(f"{name}: committed kernel {', '.join(f'{t:.3f}' for t in times['committed'])} "
                  f"ms; shared-memory design at group {groups[0]} "
                  f"{', '.join(f'{t:.3f}' for t in times['shared'])} ms", flush=True)
            for group in groups:
                ms = _median_ms(_shared_call(shared, planes, mask, ii, jj, L, cap, group, out))
                if not torch.equal(out, want[name]):
                    sys.exit(f"mism_positions_probe: shared-memory design, group {group}, "
                             f"{name}: disagrees with the plain version")
                print(f"shared-memory design, group {group:3d}, {name}: {ms:.3f} ms, "
                      f"{-(-P // group)} blocks, "
                      f"{staged_words_per_pair_word(rows, cols, group, n_planes):.2f} of "
                      f"{2 * n_planes} words staged a pair-word [OK]", flush=True)
    if args.parts:
        with open(shared_cu) as fh:
            run_parts(fh.read(), groups, ea, nm, ii, jj, L, cap, want["split layout"])


if __name__ == "__main__":
    main()
