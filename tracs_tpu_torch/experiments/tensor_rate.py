"""Issue rates of the tensor-core instructions under the split-gram kernels,
measured on the card: ``mma.sync`` and ``wgmma`` on b1 (AND + POPC) and, for
calibration against the data sheet, on int8 operands.

The data sheet of an H100 names no rate for single-bit operands, so the
bound of a b1 kernel cannot be looked up.  ``csrc/tensor_rate.cu`` runs each
instruction in a loop with its operands in place and nothing else; this
script times the loops (CUDA events, median of 5 after a warm-up, one block
an SM) and prints, per instruction, instructions a second, multiply-adds a
second, TOP/s (two operations a multiply-add), the clocks one tensor core
spends on an instruction at the card's highest SM clock, and what the split
gram's main-path block (rb=1024 x n=4096 x 1 Mb: 2.1e13 bit-products) would
take at that rate.  A yardstick for PERF.md: nothing in the port calls it.

Run: python -m tracs_tpu_torch.experiments.tensor_rate [--iters N]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from tracs_tpu_torch.runtime.device import resolve_device

#: name, the kernel's code, threads a block, instructions a loop turn of a
#: block, multiply-adds an instruction
INSTRUCTIONS = (
    ("mma.sync.m16n8k256.b1.and.popc", 0, 512, 16 * 8, 16 * 8 * 256),
    ("mma.sync.m16n8k32.s8", 1, 512, 16 * 8, 16 * 8 * 32),
    ("wgmma.m64n128k256.b1.and.popc", 2, 256, 2 * 5, 64 * 128 * 256),
    ("wgmma.m64n128k32.s8", 3, 256, 2 * 5, 64 * 128 * 32),
)
#: bit-products of the split gram's main-path block
BLOCK_MACS = 1024 * 4096 * 1_000_000 * 5


def run(iters: int, device: str | torch.device = "cuda") -> list[dict]:
    from tracs_tpu_torch.runtime.build import load_cuda_library

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("tensor_rate measures the card: it has no CPU version")
    fn = load_cuda_library("tensor_rate").tracs_tensor_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_hz = float(smi.split(",")[-1].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"# card: {smi}; {sms} SMs, 4 tensor cores each", flush=True)
    out = torch.empty(sms * 512, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(code: int, turns: int) -> None:
        rc = fn(code, sms, turns, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"tensor_rate kernel {code} launch failed: CUDA error {rc}")

    rows = []
    for name, code, _threads, per_turn, macs in INSTRUCTIONS:
        turns = iters if code < 2 else iters * 4
        launch(code, turns)
        torch.cuda.synchronize(device)
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(code, turns)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        ms = float(np.median(times))
        instr = sms * turns * per_turn
        per_s = instr / (ms / 1e3)
        row = {"name": name, "ms": ms, "instructions": instr, "instr_per_s": per_s,
               "macs_per_s": per_s * macs, "tops": 2 * per_s * macs / 1e12,
               "clocks_per_instr_per_tensor_core": 4 * sms * sm_hz / per_s,
               "main_block_ms": BLOCK_MACS / (per_s * macs) * 1e3}
        rows.append(row)
        print(f"{name}: {instr:.3e} instructions in {ms:.3f} ms, {per_s:.4e} /s, "
              f"{row['tops']:.1f} TOP/s, {row['clocks_per_instr_per_tensor_core']:.2f} clocks an "
              f"instruction a tensor core at {sm_hz / 1e6:.0f} MHz; the main-path block at this "
              f"rate: {row['main_block_ms']:.3f} ms", flush=True)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20000,
                    help="loop turns of a warp (mma.sync; 4x as many for wgmma)")
    args = ap.parse_args(argv)
    return run(args.iters)


if __name__ == "__main__":
    main()
