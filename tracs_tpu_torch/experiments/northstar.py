"""The north-star run of the port: 10,000 samples x 1 Mb all-pairs through
the real ``distance`` stage on one card (counterpart of the JAX package's
``scripts/northstar.py``, whose ``prep`` and ``cli`` it repeats over the
port's own code).

    python -m tracs_tpu_torch.experiments.northstar prep <dir> [n] [L]
    python -m tracs_tpu_torch.experiments.northstar cli <dir> [--filter] [--pack-cache DIR] [--device cuda|cpu]
    python -m tracs_tpu_torch.experiments.northstar engines <dir> [--pack-cache DIR] [--device cuda|cpu]

``prep`` writes ``big.fasta`` (``make_clustered`` with clusters of
max(6, round(0.005 n) + 1), one line a sample, nibble 0 written as ``-``)
and ``dates.csv`` (a date a sample from ``default_rng(7)`` within ten years
of 2015-01-01): byte for byte what ``scripts/northstar.py prep`` writes.
``cli`` runs ``tracs-tpu-torch distance --meta -D 200 --row-block 1024``
(with ``--filter``: into ``dists_filter.csv``) through ``cli.main``.
``engines`` packs ``big.fasta``, reads the planes into memory and runs
``pairsnp_stream`` through the split, the popcount and the
inclusion-exclusion (``mxu``) engine, comparing them block by block: each
engine once cold (its layout built and uploaded), then warm three times in
turns of alternating order (medians and every run printed).  Nothing is
downloaded.  Each subcommand prints one JSON line: rows, wall seconds,
pairs a second (n^2 over the wall, as the JAX package's record counts them),
the sha256 of the output, the pack seconds (cold: packed and stored, the
parse and the store also apart; warm: loaded from ``--pack-cache``; off: no
cache) and the peak device allocation
(``torch.cuda.max_memory_allocated``; null on the CPU).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from datetime import date, timedelta

import numpy as np
import torch

SNP_D = 200
ROW_BLOCK = 1024
#: IUPAC character of each nibble, as the JAX package's prep writes them
_LUT = np.frombuffer(b"-ACMGRSVTWYHKDBN", dtype=np.uint8)


def prep(outdir: str, n: int = 10_000, L: int = 1_000_000) -> dict:
    from tracs_tpu_torch.experiments.workload import make_clustered
    from tracs_tpu_torch.ops.packing import unpack_planes_to_nibbles

    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    packed = make_clustered(n, L, cluster_size=max(6, round(0.005 * n) + 1))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fasta = os.path.join(outdir, "big.fasta")
    with open(fasta, "wb") as fh:
        for s in range(0, n, 64):
            text = _LUT[unpack_planes_to_nibbles(packed.planes[s:s + 64], L)]
            for k in range(text.shape[0]):
                fh.write(b">s%d\n" % (s + k))
                fh.write(text[k].tobytes())
                fh.write(b"\n")
    write_s = time.perf_counter() - t0
    days = np.random.default_rng(7).integers(0, 3650, size=n)
    base = date(2015, 1, 1)
    with open(os.path.join(outdir, "dates.csv"), "w") as fh:
        fh.write("name,date\n")
        for i in range(n):
            fh.write(f"s{i},{(base + timedelta(days=int(days[i]))).isoformat()}\n")
    return {"phase": "prep", "n": n, "L": L, "data_gen_s": gen_s, "fasta_write_s": write_s,
            "fasta_bytes": os.path.getsize(fasta)}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _cache_state(fasta: str, cache_dir: str | None) -> str:
    from tracs_tpu_torch.ops.packing import pack_cache_key

    if cache_dir is None:
        return "off"
    return "warm" if os.path.isdir(os.path.join(cache_dir, pack_cache_key(fasta))) else "cold"


class _PackTimer:
    """Wraps a function and sums the seconds of its calls."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0


def _start(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device: torch.device):
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def cli(outdir: str, filt: bool = False, pack_cache: str | None = None,
        device: str = "cuda") -> dict:
    from tracs_tpu_torch import cli as port_cli
    from tracs_tpu_torch.ops import packing
    from tracs_tpu_torch.runtime.device import resolve_device
    from tracs_tpu_torch.stages import distance as distance_mod

    dev = resolve_device(device)
    fasta = os.path.join(outdir, "big.fasta")
    with open(os.path.join(outdir, "dates.csv")) as fh:
        n = sum(1 for _ in fh) - 1
    tag = "_filter" if filt else ""
    out = os.path.join(outdir, f"dists{tag}.csv")
    argv = ["distance", "--msa", fasta, "--meta", os.path.join(outdir, "dates.csv"),
            "-o", out, "-D", str(SNP_D), "--row-block", str(ROW_BLOCK), "--device", device]
    argv += ["--filter"] if filt else []
    argv += ["--pack-cache", pack_cache] if pack_cache else []
    state = _cache_state(fasta, pack_cache)
    # pack_fasta in all, and its parse and its store apart
    timers = [(distance_mod, "pack_fasta"), (packing, "_pack_uncached"),
              (packing, "_pack_cache_store")]
    timers = [(mod, name, _PackTimer(getattr(mod, name))) for mod, name in timers]
    for mod, name, timer in timers:
        setattr(mod, name, timer)
    try:
        _start(dev)
        t0 = time.perf_counter()
        port_cli.main(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        for mod, name, timer in timers:
            setattr(mod, name, timer.fn)
    pack_s, parse_s, store_s = (timer.seconds for _, _, timer in timers)
    with open(out, "rb") as fh:
        rows = sum(1 for _ in fh) - 1
    return {"phase": "cli" + tag, "n": n, "rows": rows, "wall_s": wall,
            "stage_pairs_per_s": n * n / wall, "sha256": _sha256(out),
            "pack_s": pack_s, "pack_parse_s": parse_s, "pack_store_s": store_s,
            "pack_cache": state, "peak_device_bytes": _peak(dev),
            "device": _device_name(dev)}


#: the order of the engines in each warm turn: each engine runs first, in the
#: middle and last once
_WARM_TURNS = (("split", "popcount", "mxu"), ("mxu", "split", "popcount"),
               ("popcount", "mxu", "split"))


def engines(outdir: str, pack_cache: str | None = None, device: str = "cuda") -> dict:
    from tracs_tpu_torch.ops.packing import PackedAlignment, pack_fasta
    from tracs_tpu_torch.ops.pairsnp import pairsnp_stream
    from tracs_tpu_torch.runtime.device import resolve_device

    dev = resolve_device(device)
    fasta = os.path.join(outdir, "big.fasta")
    state = _cache_state(fasta, pack_cache)
    t0 = time.perf_counter()
    packed = pack_fasta(fasta, cache_dir=pack_cache)
    pack_s = time.perf_counter() - t0
    # the planes read into memory once, so that no engine's time holds the
    # page faults of a cached entry's mmap
    t0 = time.perf_counter()
    planes = np.array(packed.planes)
    load_s = time.perf_counter() - t0
    _start(dev)

    def sweep(aln, method):
        t0 = time.perf_counter()
        blocks = list(pairsnp_stream([aln], dist=SNP_D, row_block=ROW_BLOCK, device=dev,
                                     method=method))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return blocks, time.perf_counter() - t0

    # cold: a fresh object each (no engine finds another's layouts), host
    # layout and upload included; it stays resident for the warm turns
    alns, runs, cold = {}, {}, {}
    for method in _WARM_TURNS[0]:
        alns[method] = PackedAlignment(planes, packed.length, packed.names)
        runs[method], cold[method] = sweep(alns[method], method)
    warm = {method: [] for method in alns}
    for turn in _WARM_TURNS:
        for method in turn:
            warm[method].append(sweep(alns[method], method)[1])
    split = runs["split"]
    same = {method: len(split) == len(blocks) and all(
        s[:2] == b[:2] and all(np.array_equal(x, y) for x, y in zip(s[3:], b[3:]))
        for s, b in zip(split, blocks)) for method, blocks in runs.items() if method != "split"}
    return {"phase": "engines", "n": packed.n_seqs, "rows": sum(len(b[3]) for b in split),
            "blocks": len(split), **{f"{m}_cold_s": t for m, t in cold.items()},
            **{f"{m}_warm_s": float(np.median(ts)) for m, ts in warm.items()},
            **{f"{m}_warm_runs_s": ts for m, ts in warm.items()},
            **{f"{m}_equals_split": v for m, v in same.items()},
            "equal": all(same.values()), "pack_s": pack_s, "load_s": load_s,
            "pack_cache": state, "peak_device_bytes": _peak(dev), "device": _device_name(dev)}


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("prep")
    p.add_argument("dir")
    p.add_argument("n", type=int, nargs="?", default=10_000)
    p.add_argument("L", type=int, nargs="?", default=1_000_000)
    for name in ("cli", "engines"):
        p = sub.add_parser(name)
        p.add_argument("dir")
        p.add_argument("--pack-cache", dest="pack_cache", type=os.path.abspath, default=None)
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
        if name == "cli":
            p.add_argument("--filter", action="store_true")
    args = ap.parse_args(argv)
    if args.command == "prep":
        rec = prep(args.dir, args.n, args.L)
    elif args.command == "cli":
        rec = cli(args.dir, args.filter, args.pack_cache, args.device)
    else:
        rec = engines(args.dir, args.pack_cache, args.device)
    print(json.dumps(rec), flush=True)
    return 0 if rec.get("equal", True) else 1


if __name__ == "__main__":
    sys.exit(main())
