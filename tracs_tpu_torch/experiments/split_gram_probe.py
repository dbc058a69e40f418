"""Where the gram kernels' time goes, and the alternatives their constants
were chosen from: builds variants of ``csrc/split_gram.cu`` (K1),
``csrc/popcount_gram.cu`` (K2 + K3) and ``csrc/split_gram_mma.cu`` (the
``mma.sync`` template and the ``b1-128`` ``wgmma`` kernel) by rewriting the
sources, and times each at the main-path block rb=1024 x n=4096 x 1 Mb (and,
for the cluster shapes, over the full 4096 x 4096 square) on random words.

Groups (``--groups``, default all):

* ``k1``: chunk width and ring depth, (16 words, 2 buffers) as committed
  against 8-word chunks with 3, 4 and 5 buffers; the copies without the
  ``mma`` (what the memory system delivers to the ring) and the ``mma`` with
  their fragment loads without the copies (on whatever the buffers hold);
* ``wgmma``: the cluster of ``b1-128``, 2 x 2 blocks sharing their TMA copies
  as committed, against 1 x 1, 2 x 1, 1 x 2, 4 x 1, 4 x 2 and 2 x 4;
* ``popcount``: the committed kernel (8 warps of 32 x 32 outputs) against 16
  warps of 32 x 16 outputs (128 registers), its TMA copies alone, its
  fragment loads, subset ANDs and ``mma`` without the copies (on whatever the
  first two chunks left in the ring), the same without the subset ANDs (every
  subset fed the first plane), and without the row counts;
* ``template``: for each ``mma.sync`` variant (``b1-64``, ``s8-shift-128``,
  ``s8-nibble-128``, ``bf16-128``) the committed kernel, its copies alone,
  its fragment loads, unpack and ``mma`` without the copies, the unpack alone
  (no copies, the ``mma`` replaced by an XOR into the accumulators), the
  ``mma`` alone (no copies, the unpack replaced by the packed word), and
  ``b1-64`` at other ring depths and blocks an SM.

Every full variant must give the committed kernel's outputs bit for bit; a
part's outputs mean nothing.  Each variant is compiled with the build's own
nvcc flags into a temporary directory, all at once.  A tool for PERF.md:
nothing in the port calls it.

Run: python -m tracs_tpu_torch.experiments.split_gram_probe [--groups k1,popcount]
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

from tracs_tpu_torch.runtime.build import CSRC_DIR, NVCC_FLAGS, nvcc_path
from tracs_tpu_torch.runtime.device import resolve_device

N, ROW_BLOCK, WORDS = 4096, 1024, 31252
GROUPS = ("k1", "wgmma", "popcount", "template")

_KW = "constexpr int kKW = 16;"
_STAGES = "constexpr int kStages = 2;"
_LOAD = "if (ahead < chunk1) stage(buf == 0 ? kStages - 1 : buf - 1, ahead);"
_MMA = ("        plane(acc4, cur, p);", "        plane(accn, cur, p);")
_CX, _CY = "constexpr int kWgCX = 2;", "constexpr int kWgCY = 2;"
CLUSTERS = ((2, 2), (1, 1), (2, 1), (1, 2), (4, 1), (4, 2), (2, 4))

# csrc/popcount_gram.cu
_PC_NT = "constexpr int kNT = 4;"
_PC_STEPS = "    for (int ks = 0; ks < kKW / 8; ++ks) {"
_PC_REFILL = "    if (threadIdx.x == 0 && it >= 1 && chunk - 1 + kStages < chunk1) {"
_PC_WAIT = "    mbar_wait(full(s), (it / kStages) & 1);"
_PC_AND = "  uint32_t v = 0xFFFFFFFFu;\n"
_PC_COUNT = "  if constexpr (S == 15) {"

# the mma.sync template of csrc/split_gram_mma.cu
_T_LOAD = "if (ahead < n_chunks) stage(buf == 0 ? STAGES - 1 : buf - 1, ahead);"
_T_UNPACK = "  if constexpr (DOT == kS8Shift) return unpack_s8_shift(w, reg);"
_T_FEED = ("                mma_bf16(acc[i][j], a[i], b[j]);",
           "                mma_s8(acc[i][j], a[i], b[j]);")
_T_B1_64 = "TRACS_LAUNCH(kB1, 64, 2, 2);"
#: name -> (dot code, tile) of the template's instantiations
TEMPLATE_DOTS = {"b1-64": (0, 64), "s8-shift-128": (1, 128), "s8-nibble-128": (2, 128),
                 "bf16-128": (3, 128)}


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
    out = {"K1, 16 words x 2 buffers (committed)": src}
    for stages in (3, 4, 5):
        out[f"K1, 8 words x {stages} buffers"] = _swap(
            _swap(src, _KW, "constexpr int kKW = 8;"), _STAGES,
            f"constexpr int kStages = {stages};")
    out["K1, copies only (no mma)"] = _swap(_swap(src, _MMA[0], "        ;"), _MMA[1], "        ;")
    out["K1, mma only (no copies)"] = _swap(src, _LOAD, "")
    return out


def popcount_variants(src: str) -> dict[str, str]:
    """name -> source of every variant of ``popcount_gram.cu``; the first is
    the committed kernel."""
    out = {"popcount (committed)": src}
    out["popcount, 16 warps of 32 x 16 outputs"] = _swap(src, _PC_NT, "constexpr int kNT = 2;")
    out["popcount, no row counts (part)"] = _swap(src, _PC_COUNT, "  if constexpr (S == 99) {")
    out["popcount, copies only (part)"] = _swap(
        src, _PC_STEPS, "    for (int ks = 0; ks < 0; ++ks) {")
    # nothing refills a stage and nothing waits for one: without the copies
    # no barrier holds a fast warp back, and its arrivals would run the empty
    # barrier's phases ahead of the thread that waits on them
    no_copies = _swap(_swap(src, _PC_REFILL, "    if (false) {"), _PC_WAIT,
                      "    if (it < kStages) mbar_wait(full(s), (it / kStages) & 1);")
    out["popcount, loads + ANDs + mma, no copies (part)"] = no_copies
    out["popcount, loads + mma, no ANDs, no copies (part)"] = _swap(
        no_copies, _PC_AND, "  return x0;\n" + _PC_AND)
    return out


def template_variants(src: str) -> dict[str, str]:
    """name -> source of ``split_gram_mma.cu`` with the ``mma.sync`` template
    rewritten; the first is the committed source.  Every one is timed for
    each of the template's four instantiations."""
    no_copies = _swap(src, _T_LOAD, "")
    xor = "                acc[i][j][0] += (float)(a[i][0] ^ b[j][0] ^ a[i][2] ^ b[j][1]);"
    return {
        "committed": src,
        "copies only (part)": _swap(_swap(src, _MMA[0], "        ;"), _MMA[1], "        ;"),
        "loads + unpack + mma, no copies (part)": no_copies,
        "unpack alone, no copies, XOR for mma (part)": _swap(
            _swap(no_copies, _T_FEED[0], xor), _T_FEED[1], xor.replace("(float)", "")),
        "mma alone, no copies, no unpack (part)": _swap(
            no_copies, _T_UNPACK, "  return w;\n" + _T_UNPACK),
    }


def b1_64_variants(src: str) -> dict[str, str]:
    """name -> source with ``b1-64`` at another (ring depth, blocks an SM)."""
    return {f"b1-64, {stages} buffers x {blocks} blocks an SM": _swap(
        src, _T_B1_64, f"TRACS_LAUNCH(kB1, 64, {stages}, {blocks});")
        for stages, blocks in ((2, 1), (3, 1), (5, 1))}


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
            spill = [x for x in lines[k:k + 4] if "spill stores" in x]
            if used:
                text = used[0].split("Used")[1].split(",")[0].strip()
                if spill and "0 bytes spill stores" not in spill[0]:
                    text += ", " + spill[0].split(",", 1)[1].strip()
                return text
    return "? registers"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help=f"comma-separated, of {', '.join(GROUPS)} (default all)")
    groups = ap.parse_args(argv).groups.split(",")
    if set(groups) - set(GROUPS):
        sys.exit(f"split_gram_probe: unknown group in {groups}")
    device = resolve_device("cuda")
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    def source(name):
        with open(os.path.join(CSRC_DIR, name)) as fh:
            return fh.read()

    # name -> (source, the runs of that build: (label, kind, extra ints, kernel name))
    jobs = {}
    if "k1" in groups:
        for name, src in variants(source("split_gram.cu")).items():
            jobs[name] = (src, [(name, "split_gram", (1,), "split_gram_kernel")])
    if "wgmma" in groups:
        for name, src in cluster_variants(source("split_gram_mma.cu")).items():
            jobs[name] = (src, [(name, "wgmma", (0, 128, 0), "split_gram_wgmma_kernel")])
    if "popcount" in groups:
        for name, src in popcount_variants(source("popcount_gram.cu")).items():
            jobs[name] = (src, [(name, "popcount", (1,), "popcount_gram_kernel")])
    if "template" in groups:
        mma = source("split_gram_mma.cu")
        for name, src in template_variants(mma).items():
            jobs["template, " + name] = (src, [
                (f"{vname}, {name}", "template", (dot, tile, 0),
                 f"split_gram_mma_kernelILi{dot}ELi{tile}E")
                for vname, (dot, tile) in TEMPLATE_DOTS.items()])
        for name, src in b1_64_variants(mma).items():
            jobs[name] = (src, [(name, "template", (0, 64, 0), "split_gram_mma_kernelILi0ELi64E")])

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ea = torch.randint(-2**31, 2**31, (N, 4, WORDS), dtype=torch.int32, device=device,
                       generator=gen)
    nm = torch.randint(-2**31, 2**31, (N, WORDS), dtype=torch.int32, device=device,
                       generator=gen)
    stream = torch.cuda.current_stream(device).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for k, (name, (src, _)) in enumerate(jobs.items()):
            cu, so = os.path.join(tmp, f"v{k}.cu"), os.path.join(tmp, f"v{k}.so")
            with open(cu, "w") as fh:
                fh.write(src)
            builds[name] = (so, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        want = {}   # the first full variant's outputs, per kind of function
        for name, (so, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                sys.exit(f"split_gram_probe: building {name!r} failed:\n{log[-3000:]}")
            lib = ctypes.CDLL(so)
            for label, kind, extra, entry in jobs[name][1]:
                popcount = kind == "popcount"
                fn = lib.tracs_popcount_gram if popcount else (
                    lib.tracs_split_gram if kind == "split_gram" else lib.tracs_split_gram_mma)
                inputs = (ea, ea) if popcount else (ea, nm, ea, nm)
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * len(inputs) + [ctypes.c_longlong]
                               + [ctypes.c_int] * (4 + len(extra)) + [ctypes.c_void_p] * 3)

                def call(rows: int, g, gn):
                    rc = fn(*(t.data_ptr() for t in inputs), WORDS, 0, rows, 0, N, *extra,
                            g.data_ptr(), gn.data_ptr(), stream)
                    if rc != 0:
                        raise RuntimeError(f"{label}: launch failed, CUDA error {rc}")

                g = torch.empty((ROW_BLOCK, N), dtype=torch.int32, device=device)
                gn = torch.empty_like(g)
                ms = _median_ms(lambda: call(ROW_BLOCK, g, gn))
                text = f"{label}: block {ms:.3f} ms"
                if kind == "wgmma":
                    gs = torch.empty((N, N), dtype=torch.int32, device=device)
                    gns = torch.empty_like(gs)
                    text += f", full square {_median_ms(lambda: call(N, gs, gns), 3):.3f} ms"
                    del gs, gns
                verdict = ""
                if "only" not in label and "(part)" not in label:
                    key = "popcount" if popcount else "split"
                    if key not in want:
                        want[key] = (g.clone(), gn.clone())
                    same = torch.equal(g, want[key][0]) and torch.equal(gn, want[key][1])
                    verdict = " [OK]" if same else " [MISMATCH]"
                    if not same:
                        sys.exit(f"split_gram_probe: {label!r} disagrees with the committed "
                                 f"kernel of its function")
                print(f"{text}, {_registers(log, entry)}{verdict}", flush=True)


if __name__ == "__main__":
    main()
