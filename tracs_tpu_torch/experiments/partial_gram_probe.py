"""The correction-gram kernel at the main path's block in its block tile,
128 x 64 on a ring of two chunks, beside a 128 x 128 tile on a ring of one.

``csrc/partial_gram.cu`` is built for one tile (``using PartialTile =
Tile<64, 2>;``).  This probe writes a copy of the source with that line
swapped for ``Tile<128, 1>``, builds it with the build's own flags, and on
random partial planes of the headline's block (rows [0, row_block) against
all n samples, ``--words`` words, brought to the card's pitch by
``pad_planes``) times both in turns (committed, 128, 128, committed), each
call in CUDA events, with the build facts of each (registers, local and
shared bytes, from ``cudaFuncGetAttributes``).  Both must equal the plain
version ``partial_gram_reference`` exactly.  Prints the card's name and power
limit first and one JSON line last.  A tool for PERF.md: nothing in the port
calls it, and the wrapper cannot reach the 128-column tile.

Run: python -m tracs_tpu_torch.experiments.partial_gram_probe [--n 4096]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.runtime.build import CSRC_DIR, NVCC_FLAGS, load_cuda_library, nvcc_path
from tracs_tpu_torch.runtime.device import resolve_device

_TILE = "using PartialTile = Tile<64, 2>;"
_WIDE = "using PartialTile = Tile<128, 1>;"


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


def _typed(lib: ctypes.CDLL):
    """(the entry point, the attributes entry) of a partial_gram library."""
    fn = lib.tracs_partial_gram
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    facts = lib.tracs_partial_gram_attributes
    facts.restype = ctypes.c_int
    facts.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    return fn, facts


def build_facts(facts) -> dict:
    vals = [ctypes.c_int() for _ in range(3)]
    rc = facts(*(ctypes.byref(v) for v in vals))
    if rc != 0:
        sys.exit(f"partial_gram_probe: cudaFuncGetAttributes failed with CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "shared_bytes"), (v.value for v in vals)))


def build_wide(tmp: str) -> ctypes.CDLL:
    """The 128 x 128 tile: a copy of the committed source with its tile line
    swapped, built into ``tmp``."""
    with open(os.path.join(CSRC_DIR, "partial_gram.cu")) as fh:
        src = fh.read()
    if _TILE not in src:
        sys.exit(f"partial_gram_probe: the kernel source no longer holds {_TILE!r}: bring this "
                 f"script up to date")
    cu, so = os.path.join(tmp, "partial_gram_wide.cu"), os.path.join(tmp, "partial_gram_wide.so")
    with open(cu, "w") as fh:
        fh.write(src.replace(_TILE, _WIDE))
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", so, cu],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        sys.exit(f"partial_gram_probe: building the 128 x 128 tile failed:\n{r.stderr[-3000:]}")
    return ctypes.CDLL(so)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096, help="samples (the block's columns)")
    ap.add_argument("--row-block", type=int, default=1024)
    ap.add_argument("--words", type=int, default=64,
                    help="words of the partial planes (the headline's 2048 partial sites)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    planes = torch.randint(-2**31, 2**31, (args.n, 4, args.words), dtype=torch.int32,
                           device=device, generator=gen)
    a, b = planes[:args.row_block], planes
    pa, pb = kernels.pad_planes(a), kernels.pad_planes(b)
    na, nb, Wp = pa.shape[0], pb.shape[0], pa.shape[2]
    want = kernels.partial_gram_reference(a, b)
    out = torch.empty((na, nb), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    with tempfile.TemporaryDirectory() as tmp:
        libs = {"128x64 (committed)": load_cuda_library("partial_gram"),
                "128x128": build_wide(tmp)}
        tiles = {}
        for name, lib in libs.items():
            fn, facts = _typed(lib)

            def call(fn=fn):
                rc = fn(pa.data_ptr(), pb.data_ptr(), na, nb, Wp, 0, out.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed, CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"partial_gram_probe: the {name} tile disagrees with the plain version")
            tiles[name] = {"call": call, "ms": [], **build_facts(facts)}
            print(f"# {name}: equal to the plain version; {tiles[name]['registers']} registers, "
                  f"{tiles[name]['local_bytes']} B local, {tiles[name]['shared_bytes']} B shared",
                  flush=True)
        first, wide = libs
        for name in (first, wide, wide, first):
            tiles[name]["ms"].append(_median_ms(tiles[name]["call"]))
        rec = {"block": [na, nb], "words": Wp}
        for name, t in tiles.items():
            rec[name] = {"ms": float(np.median(t["ms"])), "turns": t["ms"],
                         **{k: t[k] for k in ("registers", "local_bytes", "shared_bytes")}}
            print(f"# {name}: {rec[name]['ms']:.4f} ms (median of the turns "
                  f"{', '.join(f'{x:.4f}' for x in t['ms'])})", flush=True)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
