"""Where the split-gram kernels' time goes, and the alternatives their
constants were chosen from: builds variants of ``csrc/split_gram.cu`` (K1)
and of the ``b1-128`` variant of ``csrc/split_gram_mma.cu`` by rewriting the
sources, and times each at the main-path block rb=1024 x n=4096 x 1 Mb (and,
for the cluster shapes, over the full 4096 x 4096 square) on random words.

* chunk width and ring depth: (16 words, 2 buffers), the kernel as committed,
  against 8-word chunks with 3, 4 and 5 buffers (the same shared memory
  bought as a deeper ring of narrower rows);
* the parts of the loop alone: the copies without the ``mma`` (what the
  memory system delivers to the ring) and the ``mma`` with their fragment
  loads without the copies (on whatever the buffers hold), for the committed
  constants;
* the cluster of ``b1-128``: 2 x 2 blocks share their TMA copies as
  committed, against a block on its own (1 x 1) and clusters of 2 x 1, 1 x 2,
  4 x 1, 4 x 2 and 2 x 4.

Every full variant must give the committed kernel's outputs bit for bit.
Each variant is compiled with the build's own nvcc flags into a temporary
directory.  A tool for PERF.md: nothing in the port calls it.

Run: python -m tracs_tpu_torch.experiments.split_gram_probe
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from tracs_tpu_torch.runtime.build import CSRC_DIR, NVCC_FLAGS, nvcc_path
from tracs_tpu_torch.runtime.device import resolve_device

N, ROW_BLOCK, WORDS = 4096, 1024, 31252

_KW = "constexpr int kKW = 16;"
_STAGES = "constexpr int kStages = 2;"
_LOAD = "if (ahead < chunk1) stage(buf == 0 ? kStages - 1 : buf - 1, ahead);"
_MMA = ("        plane(acc4, cur, p);", "        plane(accn, cur, p);")
_CX, _CY = "constexpr int kWgCX = 2;", "constexpr int kWgCY = 2;"
CLUSTERS = ((2, 2), (1, 1), (2, 1), (1, 2), (4, 1), (4, 2), (2, 4))


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"the kernel source no longer holds {old!r}: bring this script up to date")
    return src.replace(old, new)


def cluster_variants(src: str) -> dict[str, str]:
    """name -> source of ``split_gram_mma.cu`` for every cluster shape; the
    first is the committed one."""
    return {f"b1-128, cluster {cx} x {cy}" + (" (committed)" if (cx, cy) == CLUSTERS[0] else ""):
            _swap(_swap(src, _CX, f"constexpr int kWgCX = {cx};"), _CY,
                  f"constexpr int kWgCY = {cy};")
            for cx, cy in CLUSTERS}


def variants(src: str) -> dict[str, str]:
    """name -> source of every variant of ``split_gram.cu``; the first is the
    committed kernel."""
    out = {"16 words x 2 buffers (committed)": src}
    for stages in (3, 4, 5):
        out[f"8 words x {stages} buffers"] = _swap(
            _swap(src, _KW, "constexpr int kKW = 8;"), _STAGES,
            f"constexpr int kStages = {stages};")
    out["copies only (no mma)"] = _swap(_swap(src, _MMA[0], "        ;"), _MMA[1], "        ;")
    out["mma only (no copies)"] = _swap(src, _LOAD, "")
    return out


def _median_ms(fn, reps: int = 5) -> float:
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


def _registers(log: str, entry: str) -> str:
    """ptxas' register count of the kernel whose mangled name holds ``entry``."""
    lines = log.splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry function" in ln and entry in ln:
            used = [x for x in lines[k:k + 4] if "Used" in x and "registers" in x]
            if used:
                return used[0].split("Used")[1].split(",")[0].strip()
    return "? registers"


def main() -> None:
    device = resolve_device("cuda")
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    with open(os.path.join(CSRC_DIR, "split_gram.cu")) as fh:
        k1 = variants(fh.read())
    with open(os.path.join(CSRC_DIR, "split_gram_mma.cu")) as fh:
        wg = cluster_variants(fh.read())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ea = torch.randint(-2**31, 2**31, (N, 4, WORDS), dtype=torch.int32, device=device,
                       generator=gen)
    nm = torch.randint(-2**31, 2**31, (N, WORDS), dtype=torch.int32, device=device,
                       generator=gen)
    stream = torch.cuda.current_stream(device).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for k, (name, src) in enumerate({**k1, **wg}.items()):
            cu, so = os.path.join(tmp, f"v{k}.cu"), os.path.join(tmp, f"v{k}.so")
            with open(cu, "w") as fh:
                fh.write(src)
            builds[name] = (so, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        want = None
        for name, (so, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                sys.exit(f"split_gram_probe: building {name!r} failed:\n{log[-3000:]}")
            lib = ctypes.CDLL(so)
            if name in k1:
                fn, extra, entry = lib.tracs_split_gram, (1,), "split_gram_kernel"
            else:   # dot = b1, tile = 128, no flush
                fn, extra, entry = lib.tracs_split_gram_mma, (0, 128, 0), "split_gram_wgmma_kernel"
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                           + [ctypes.c_int] * (4 + len(extra)) + [ctypes.c_void_p] * 3)

            def call(rows: int, g, gn):
                rc = fn(ea.data_ptr(), nm.data_ptr(), ea.data_ptr(), nm.data_ptr(), WORDS, 0,
                        rows, 0, N, *extra, g.data_ptr(), gn.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

            g = torch.empty((ROW_BLOCK, N), dtype=torch.int32, device=device)
            gn = torch.empty_like(g)
            ms = _median_ms(lambda: call(ROW_BLOCK, g, gn))
            text = f"{name}: block {ms:.3f} ms"
            if name in wg:
                gs = torch.empty((N, N), dtype=torch.int32, device=device)
                gns = torch.empty_like(gs)
                text += f", full square {_median_ms(lambda: call(N, gs, gns), 3):.3f} ms"
                del gs, gns
            verdict = ""
            if "only" not in name:
                if want is None:
                    want = (g.clone(), gn.clone())
                same = torch.equal(g, want[0]) and torch.equal(gn, want[1])
                verdict = " [OK]" if same else " [MISMATCH]"
                if not same:
                    sys.exit(f"split_gram_probe: {name!r} disagrees with the committed K1")
            print(f"{text}, {_registers(log, entry)}{verdict}", flush=True)


if __name__ == "__main__":
    main()
