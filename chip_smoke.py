#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tracs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each one passes or the script exits non-zero):

0. the card's name and power limit, from nvidia-smi;
1. the build of every kernel from the sources in the checkout (one nvcc per
   source, all started together, sm_90a), with its seconds and ptxas report;
   then the port's ``doctor`` runtime check (``check_runtime``: the native
   library, torch and its CUDA, the card, nvcc, every kernel source), which
   fails the run on any problem line, and the versions of matplotlib and
   pandas (or ``absent``: the port imports neither outside ``plot``);
2. each kernel against its plain PyTorch version on the card, exact equality,
   at two ragged shapes (word counts that are no multiple of the 16-word
   chunk, rows and columns that are no multiple of a tile), a rectangle with
   r0 > 0 and c0 > 0, and the main-path shape rb=1024 x n=4096 x W=31250,
   with the median ms of both: ``split_gram`` (K1), every tensor-core variant
   of ``split_gram_variant`` (K1', on K1's inputs, so their times stand
   beside K1's) and ``popcount_gram`` (K2 + K3).  The split layouts and the
   raw planes carry the card's word pitch (``pad_layout``, ``pad_planes``:
   zero words up to a multiple of 4).  Then K1 and ``popcount_gram`` at the
   four blocks of the main path's sweep (rb=1024 against the column suffixes
   m=4096, 3072, 2048, 1024), exact against their plain versions, timed as
   the launchers run them (the word axis cut into parts where whole tiles
   would leave SMs idle) and with the cut forced off.  Then the main path's
   two device steps after the grams, exact against their plain versions
   (``block_kernels``): ``partial_gram`` (the correction gram, on the b1
   tensor cores) at ragged shapes whose partial planes ``pad_planes`` brings
   to the card's pitch and at the four blocks of the sweep with 2048 partial
   sites (64 words), and ``coo_extract`` (D/NN assembly, threshold,
   triangle mask and row-major compaction in one launch, its output sized
   on the host) on synthetic grams at the four blocks, a mesh slab whose
   last columns lie past n_valid, a ragged block and a 1 x 1 one, in the
   three ways the engines call it and at the thresholds -1, 0, 200 and 2^31 - 1, where the
   output must be exactly filled; each timed beside its plain version, which
   is the port's route before the kernels (float64 unpack and ``mm``; D and
   NN assembled, then ``torch.nonzero``), with its build facts (registers,
   local and shared bytes, from ``cudaFuncGetAttributes``).  At the first
   block, the library's time of K1's, K2+K3's and the correction gram's
   function: the int8 products the JAX package computes them by
   (``_dense_split``, ``_gram_mxu`` over word chunks, ``_gram_partial``), as
   ``torch._int_mm`` calls on operands unpacked to 0/1 int8 beforehand (the
   unpack timed apart), each equal to the kernel's output.  Last, the split
   layout built on the card (``layout_kernels``): ``split_layout`` and its
   gather ``split_gather`` against their plain versions on random words,
   exact, at ragged shapes and at 4,096 samples x 31,250 words with 2,048
   partial sites, timed on the card (``device_ms``) beside their bytes bound;
3. the distance slice through the normal entry point
   (``tracs_tpu_torch.cli.main(["distance", ...])``) on the headline
   workload: n=4096 samples x 1 Mb in clusters of 21, 2048 partial-IUPAC
   columns, seed 0, written as an uncompressed FASTA in a temp dir
   (``tracs_tpu_torch.io.fasta.write_fasta``).  Checks that every row block
   launched the split-gram, correction-gram and extraction kernels (the same
   for every ``distance`` run below), that the split layout was built on the
   card once (one layout and one gather launch), that the CSV holds
   exactly the within-cluster pairs, and that 2,000 sampled rows agree with a
   host numpy popcount over the raw planes.  Prints wall seconds, pairs/s and
   the CSV's sha256.  Then the headline bench's timed sweeps
   (``tracs_tpu_torch.experiments.bench.bench_gpu``, ``--method split``) on
   the headline's alignment, its result printed: its survivors must equal the
   CLI run's rows and ``split_gram``, ``partial_gram`` and ``coo_extract``
   must each launch once a row block in each of its 7 sweeps (two warm-ups,
   five timed).  Then the pack cache on the same FASTA: a cold
   ``pack_fasta(cache_dir=...)`` packs and stores, a warm one loads the
   planes, which must be equal (both times printed), and one ``distance
   --pack-cache`` run served from the cache must write the same bytes;
4. the sweep alone (``pairsnp_stream``) through both engines, cold and warm:
   the popcount engine must launch ``popcount_gram`` and ``coo_extract`` once
   per row block and yield, array for array, what the split engine yields.
   The warm split sweep is split by step (CUDA events around K1,
   ``partial_gram`` and ``coo_extract``; the rest is host time).  Then, warm,
   ``method="mxu"``, whose route on the card is ``popcount_gram`` (the
   15-channel gram of the JAX package's ``_gram_mxu`` is the kernel's own
   15 subset grams): once per row block (``coo_extract`` too), the split
   engine's arrays, and the
   route's (g, gq) at the first block against ``_gram_mxu`` and against
   ``torch._int_mm``'s (the route's library time).  On the layouts
   that stay resident, ``mismatch_positions_kernel`` against its plain
   version, exact on the whole table: the first row block's emitted pairs at
   the capacity the filter gives it, where the wrapper's rule must take the
   tiled kernel (timed a call and on the card alone, in turns with the first
   version, the warp kernel, and with the rule's host part), a ragged length
   with a capacity below some counts, and the five pair patterns of the
   card tests over the first 64 samples through both kernels, each through
   the split layout and the raw planes;
5. ``distance --meta`` through the CLI on the same workload, with a seeded
   date per sample (a base date per cluster, members 0-180 days after it):
   the split kernel once per row block, the same rows as phase 3, p0 in
   [0, 1], E(K) finite and >= 0, and 2,000 sampled rows against the scalar
   ``lprob_k_given_N`` and the model run on the CPU (rtol 1e-9);
6. ``trans_dist`` alone on the card: its time on the run's unique (N, delta)
   lanes; the k loop's kernel (``csrc/trans_k_loop.cu``) at one lookup of a
   job's lanes (3,425 drawn from the run's) against the blocked engine on the
   card (exit k equal, E(K) at 1e-12), timed beside it with its latency
   bound; the reference goldens at 1e-6; then the transmission-model
   bench (``tracs_tpu_torch.experiments.transcluster_bench``) on its
   synthetic mix of 250,000 rows, its JSON line printed;
7. ``distance --filter`` through the CLI on the same workload: the tiled
   mismatch-position kernel launched for every block (the warp kernel
   never), ``filter_pairs``' time split by step (the ``scipy.stats``
   import, also timed in a fresh process, the keep-table builds, the native
   window pass, the kernel, the table's copy to the host, the rest), the
   same rows and raw distances as
   phase 3, 0 <= filtered <= raw on every row, and 2,000 sampled rows equal
   to the host bitset path (``filter_recomb_batch(mismatch_words(...))`` on
   the numpy planes).  Prints wall seconds, the filter's share and the sha256;
8. a planted case through ``pairsnp_stream(filter=True)``: 256 samples x
   1 Mb off one base genome (so the compaction drops almost every column and
   its position map is in use), scattered SNPs on every sample and a tract of
   30 SNPs within 2 kb on every fourth; each pair with a tract must lose it
   to the filter, and every pair must equal the host bitset path; the
   mismatch-position launches printed by kernel (whole rows of pairs with
   no threshold: the rule takes the warp kernel);
9. the variant sweep through its entry point
   (``tracs_tpu_torch.experiments.kernel_experiments.main``) at full width,
   n=4096 x 1 Mb over the full square: every variant launched and ``OK``
   against K1, ms and pairs/s printed.  Then, at that shape and on that
   layout, K1 and every variant against its plain version, exact: the
   variants' times, plain times and bounds in the JSON line are those of the
   full square, the shape their own path gives them (their block times stay
   beside them as ``block_ms`` and ``block_plain_ms``), and so is their
   library time (``torch._int_mm`` G4 + Gn over the square).

10. reads to clusters through the normal entry point
   (``tracs_tpu_torch.cli.main(["pipe", ...])``, ``--device`` left at its
   default): one reference genome of 2,000,000 sites and 16 samples in four
   planted clusters (members a few SNPs apart, clusters hundreds apart), each
   with stretches without coverage, stretches of one read a strand and mixed
   sites with two alleles on both strands, made from the seed with numpy.
   The database zip is built by the ``build-db`` stage from the reference
   and a decoy genome: no sourmash there, so it holds the genomes and the
   port's own FracMinHash sketches and no SBT, and every sample's reference is chosen by
   the native gather from its read file (a FASTQ holding its genome).  Only
   the aligner subprocess is stood in for: a function writes the sample's
   htsbox-format pileup where minimap2 | samtools | htsbox would have.  The
   run fails unless every called FASTA equals the planted genome with N on
   the low-coverage stretches and the planted IUPAC code at the mixed sites,
   ``transmission_distances.csv`` holds exactly the planted within-threshold
   pairs with the planted SNP distances and sites considered,
   ``transmission_clusters.csv`` groups exactly the planted clusters, the
   split-gram, correction-gram and extraction kernels were launched once a
   row block, and both model functions were handed
   their counts on the card and allocated there (the model ran there).  Then
   the run's combined alignment is packed and laid out as ``distance`` does
   and, at that shape, ``split_gram`` is held against its plain version
   and ``torch._int_mm``'s G4 + Gn (exact; its 16 rows padded to the 17
   that ``_int_mm`` needs) and the sweep's distance and sites considered of every one of
   the 120 pairs against the planted ones.  ``threshold`` then fits its
   mixture to the close pairs (``pipe``'s distance CSV: the pairs within a
   planted cluster) and the distant ones (the sweep's cross-cluster pairs),
   and the run fails unless the cutoff lies between the two.  Prints the wall of ``pipe`` and
   its split by function, the two model functions on the CPU at the same size
   beside the card's, and whether the real aligner binaries are on PATH.

11. the dp x sp mesh (``tracs_tpu_torch.parallel``) on the headline
   workload, its planes read from phase 3's pack cache (run inside the
   headline's temp dir, after phase 7).  (a) nccl in a world of one, in this
   process: the triangle ring (from row 0) and the block sweep (from row
   1024) over a 1 x 1 ``DeviceMesh`` through ``pairsnp_stream(mesh=...)``,
   each array for array equal to the one-device stream: the only place the
   nccl calls run, since a call has one card and nccl refuses two ranks on
   one device.  (b) gloo ranks sharing cuda:0, spawned as worlds of 2 and 4
   processes (each ``initialize(..., backend="gloo")``, each world with a
   timeout): the ``distance`` CLI with ``--mesh 2x1`` (the ring), ``--mesh
   1x2`` (the ring at dp = 1 with an sp reduction) and ``--mesh 2x2
   --filter``, every CSV (``.procN`` included) hashing to phase 3's (phase
   7's with ``--filter``), every mismatch-position launch of the last on the
   tiled kernel; the block sweep through the API from row 1024 on
   2 x 2, every rank's arrays equal to the one-device stream's; one shard's
   ring block against ``split_gram_reference`` and ``torch._int_mm``'s
   products (the library time at that shape).  Prints each run's wall, the
   ranks' peak device allocation and the bytes through the collectives; for
   the three ring runs (1x1, 2x1, 1x2) the peak against the ring's plan
   (``RingCoo.stripe_bytes`` + ``operand_bytes``), failing where it exceeds
   the plan with its temporaries' budget.
   None of it is a scaling number: the ranks share one card's SMs and talk
   through host memory.

No phase was cut when later ones were added.

The line before the last is a JSON object describing each kernel (its
launches on its main path, its error and times against its plain version, and
the least time the card could take for the same work, the only number in it
that is computed and not measured; what else the script computes about a
bound goes to ``# bound of`` comment lines).  The last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout, the
script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: row block of the distance run: the JAX package's headline setting
ROW_BLOCK = 1024
#: the transmission model's defaults (tracs distance --clock_rate/--trans_rate/--precision)
LAMB, BETA, PRECISION = 1e-3 * 29903, 73.0, 0.01


#: published dense peaks of one H100 SXM (NVIDIA's data sheet): tensor-core
#: int8 and bf16 operations a second, and device-memory bytes a second
PEAK_INT8, PEAK_BF16, PEAK_BYTES = 1979e12, 989e12, 3.35e12
#: single-bit (AND + POPC) tensor-core operations a second.  The data sheet
#: names no such rate; a b1 instruction covers 8 times the sites of the int8
#: one of the same shape and issues as fast (wgmma m64n128k256 b1 against
#: m64n128k32 s8: 15.8 POP/s against 1.97 POP/s measured on an H100 at 700 W),
#: so the peak is 8 x int8's
PEAK_B1 = 8 * PEAK_INT8
#: the tensor cores' peak for the operand type of a split-gram kernel
PEAK_BY_DOT = {"b1": PEAK_B1, "s8": PEAK_INT8, "bf16": PEAK_BF16}
#: integer operations a second outside the tensor cores: the data sheet's
#: 67 TFLOP/s of float32 counts a fused multiply-add as two
PEAK_CUDA_CORE = 33.5e12
#: samples of the planted recombination case (phase 8)
PLANTED_N = 256
#: the reads-to-clusters run (phase 10): sites of the reference genome (a small
#: bacterial genome), samples, planted clusters
PIPE_SITES, PIPE_SAMPLES, PIPE_CLUSTERS = 2_000_000, 16, 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """(the least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over their peak."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_bound(what: str, na: int, nb, W: int, r0: int, rb: int, c0: int, *, planes: int,
               products: int, peak_ops: float, popc: int, card, outputs: int = 2):
    """Bound of a gram kernel call, {bound_ms, bound_by}: every distinct input
    row read once (``planes`` words per 32 sites) and the ``outputs`` int32
    outputs written once, against the operations of the cheaper of the two routes
    that compute the function: ``products`` bit-products per site pair as
    multiply-adds at the tensor cores' ``peak_ops`` (the peak of the operand
    type the kernel feeds them; single-bit for a kernel on the CUDA cores,
    whose function the b1 instructions compute too), or ``popc`` POPC per word
    pair on the CUDA cores (16 a clock on each SM at the card's highest SM
    clock).  Prints both routes' times on a comment line."""
    m = (na if nb is None else nb) - c0
    if nb is None:
        rows = rb + m - max(0, min(r0 + rb, na) - max(r0, c0))
    else:
        rows = rb + m
    t_mma = 2 * products * rb * m * 32 * W / peak_ops * 1e3
    t_popc = popc * rb * m * W / (16 * card["sms"] * card["sm_hz"]) * 1e3
    t_bytes = (rows * planes * W * 4 + outputs * rb * m * 4) / PEAK_BYTES * 1e3
    t_ops = min(t_mma, t_popc)
    ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"# bound of {what}: {ms:.3f} ms by {by}; tensor-core route ({products} bit-products "
          f"a site pair) {t_mma:.3f} ms, CUDA-core route ({popc} POPC a word pair) "
          f"{t_popc:.3f} ms")
    return {"bound_ms": ms, "bound_by": by}


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from tracs_tpu_torch.runtime import profiling

    profiling.reset("kernel.launches.")


def launches(kernel: str) -> int:
    """Launches of ``kernel`` since the last ``reset_counts``: the counter
    ``kernel.launches.<kernel>`` of runtime/profiling.py."""
    from tracs_tpu_torch.runtime import profiling

    return profiling.counter("kernel.launches." + kernel)


def read_counts() -> dict:
    from tracs_tpu_torch.ops import kernels

    return {"split_gram": launches("split_gram"),
            "popcount_gram": launches("popcount_gram"),
            "mism_positions": launches("mism_positions"),
            "mism_positions (tiled)": launches("mism_positions_tiled"),
            "coo_extract": launches("coo_extract"),
            "partial_gram": launches("partial_gram"),
            "split_layout": launches("split_layout"),
            "split_gather": launches("split_gather"),
            "trans_k_loop": launches("trans_k_loop"),
            **{name: launches("split_gram_mma." + name)
               for name in (kernels.variant_name(*v) for v in kernels.SPLIT_GRAM_VARIANTS)}}


# ---------------------------------------------------------------------------
# the headline workload (bench.py's make_clustered, from the package) on disk
# ---------------------------------------------------------------------------

def fasta_records(packed, batch: int = 128):
    """(name, sequence) records of a PackedAlignment, unpacked ``batch``
    sequences at a time, for ``tracs_tpu_torch.io.fasta.write_fasta``."""
    from tracs_tpu_torch.ops.packing import IUPAC_BY_NIBBLE, unpack_planes_to_nibbles

    chars = IUPAC_BY_NIBBLE.view(np.uint8)
    for s in range(0, packed.n_seqs, batch):
        text = chars[unpack_planes_to_nibbles(packed.planes[s : s + batch], packed.length)]
        for k in range(text.shape[0]):
            yield packed.names[s + k], text[k].tobytes().decode("ascii")


def oracle(planes: np.ndarray, length: int, i: np.ndarray, j: np.ndarray):
    """(SNP distance, sites considered) of pairs (i, j) by a host popcount
    over the raw planes: d = L - popcount(OR_x(a_x & b_x)),
    nn = L - popcount(N_a | N_b)."""
    from tracs_tpu_torch.ops.packing import popcount_words

    d = np.empty(len(i), dtype=np.int64)
    nn = np.empty(len(i), dtype=np.int64)
    for k in range(0, len(i), 64):
        a, b = planes[i[k : k + 64]], planes[j[k : k + 64]]
        shared = (a[:, 0] & b[:, 0]) | (a[:, 1] & b[:, 1]) | (a[:, 2] & b[:, 2]) | (a[:, 3] & b[:, 3])
        na = a[:, 0] & a[:, 1] & a[:, 2] & a[:, 3]
        nb = b[:, 0] & b[:, 1] & b[:, 2] & b[:, 3]
        d[k : k + 64] = length - popcount_words(shared).sum(axis=1)
        nn[k : k + 64] = length - popcount_words(na | nb).sum(axis=1)
    return d, nn


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events around each run."""
    import torch

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


def device_ms(fn, reps: int = 20) -> float:
    """Milliseconds of the card's own work a run of ``fn()``, which must not
    wait for the card: ``reps`` runs queued back to back behind a spin of
    ~10 ms on the card (``torch.cuda._sleep``), so that the host's time to
    queue them is hidden and CUDA events around them time the card alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int8_bits(words):
    """Packed words [n, ..., w] as 0/1 int8 [n, sites] (channels one after
    another), unpacked 256 rows at a time."""
    import torch

    from tracs_tpu_torch.ops.kernels import _unpack_bits

    out = torch.empty((words.shape[0], words[0].numel() * 32), dtype=torch.int8,
                      device=words.device)
    for s in range(0, words.shape[0], 256):
        chunk = words[s:s + 256]
        out[s:s + 256] = _unpack_bits(chunk).view(torch.int8).reshape(chunk.shape[0], -1)
    return out


def library_split_gram(ea, nm, r0: int, rb: int, c0: int, eb=None, nmb=None):
    """``split_gram``'s function the way the JAX package computes it outside
    any Pallas kernel (``_dense_split``, tracs_tpu/ops/pairsnp.py:210): the
    4 exclusive planes' bits and the N masks' bits as int8 products with int32
    sums, G4 and Gn, by ``torch._int_mm`` (two calls; the card's memory freed
    first).  The operands are unpacked beforehand, timed apart and not
    counted.  ``_int_mm`` takes more than 16 rows and a multiple of 8
    columns: a smaller block gets zero rows and columns past its own, which
    the result leaves out (the pipe run's 16 x 16).  Returns (ms of the two
    calls, median of 5, seconds of the unpack, (G4 - Gn, Gn))."""
    import torch
    from torch.nn.functional import pad

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if eb is None:
        b4, bn = int8_bits(ea), int8_bits(nm)
        a4, an = b4[r0:r0 + rb], bn[r0:r0 + rb]
    else:
        a4, an = int8_bits(ea[r0:r0 + rb]), int8_bits(nm[r0:r0 + rb])
        b4, bn = int8_bits(eb), int8_bits(nmb)
    b4, bn = b4[c0:], bn[c0:]
    m = b4.shape[0]
    if rb <= 16 or m % 8:
        a4, an = (pad(x, (0, 0, 0, max(0, 17 - rb))) for x in (a4, an))
        b4, bn = (pad(x, (0, 0, 0, -m % 8)) for x in (b4, bn))
    b4, bn = b4.t(), bn.t()
    torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t0

    def call():
        return torch._int_mm(a4, b4), torch._int_mm(an, bn)

    g4, gn = (g[:rb, :m] for g in call())
    ms = time_ms(call, 5)
    return ms, unpack_s, (g4 - gn, gn)


def library_partial_gram(pa, pb):
    """``partial_gram``'s function the way the JAX package computes it
    (``_gram_partial``, tracs_tpu/ops/pairsnp.py:184): the bits of the 10
    plane-pair and plane-triple AND channels, B's signed (-1 pairs, +1
    triples), as one int8 product with int32 sums by ``torch._int_mm``.  The
    operands are unpacked beforehand, timed apart and not counted.  Returns
    (ms, median of 5, seconds of the unpack, the gram)."""
    import torch

    from tracs_tpu_torch.ops import kernels

    channels = [s - 1 for s in kernels._PAIR_SUBSETS + kernels._TRIPLE_SUBSETS]
    t0 = time.perf_counter()
    xa = int8_bits(kernels._subset_products(pa)[:, channels].contiguous())
    xb = int8_bits(kernels._subset_products(pb)[:, channels].contiguous())
    signs = torch.tensor(kernels._PARTIAL_SIGNS, device=pa.device).to(torch.int8)
    zb = (xb.view(xb.shape[0], len(channels), -1) * signs[None, :, None]).view(xb.shape[0], -1)
    torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t0
    gram = torch._int_mm(xa, zb.t())
    ms = time_ms(lambda: torch._int_mm(xa, zb.t()), 5)
    return ms, unpack_s, gram


def library_popcount_gram(pa, r0: int, rb: int, c0: int, signs, pb=None,
                          chunk_words: int = 2048):
    """``popcount_gram``'s function the way the JAX package's mxu engine
    computes it outside any Pallas kernel (``_gram_mxu``,
    tracs_tpu/ops/pairsnp.py:114): the bits of the 15 plane-subset AND
    channels, B's signed by ``signs`` (one a subset), as one int8 product
    with int32 sums, and the N mask's bits (the 4-plane subset) as a second,
    by ``torch._int_mm``.  At the main path's block the 15 channels are
    77 GB of int8 operands, more than the card holds, so both products run
    over chunks of ``chunk_words`` words, as ``_gram_mxu`` runs over word
    chunks: each chunk's operands are unpacked beforehand (timed apart, not
    counted), its two calls timed (median of 3), and the chunks' times
    summed.  Returns (ms, seconds of the unpack, (signed gram, N gram),
    (N count of each row, of each column))."""
    import torch

    from tracs_tpu_torch.ops import kernels

    gc.collect()
    torch.cuda.empty_cache()
    a, b = pa[r0:r0 + rb], (pa if pb is None else pb)[c0:]
    m = b.shape[0]
    sign = torch.tensor(signs, device=pa.device).to(torch.int8)[None, :, None]
    gram = torch.zeros((rb, m), dtype=torch.int32, device=pa.device)
    gn = torch.zeros_like(gram)
    cnt_a = torch.zeros(rb, dtype=torch.int64, device=pa.device)
    cnt_b = torch.zeros(m, dtype=torch.int64, device=pa.device)
    ms = unpack_s = 0.0
    for w0 in range(0, pa.shape[2], chunk_words):
        t0 = time.perf_counter()
        xa = int8_bits(kernels._subset_products(a[:, :, w0:w0 + chunk_words]))
        zb = int8_bits(kernels._subset_products(b[:, :, w0:w0 + chunk_words]))
        an = xa.view(rb, 15, -1)[:, 14].contiguous()
        bn = zb.view(m, 15, -1)[:, 14].contiguous()
        zb.view(m, 15, -1).mul_(sign)
        cnt_a += an.sum(dim=1)
        cnt_b += bn.sum(dim=1)
        torch.cuda.synchronize()
        unpack_s += time.perf_counter() - t0

        def call():
            return torch._int_mm(xa, zb.t()), torch._int_mm(an, bn.t())

        g, n = call()
        gram += g
        gn += n
        ms += time_ms(call, 3)
        del xa, zb, an, bn, g, n
    torch.cuda.empty_cache()
    return ms, unpack_s, (gram, gn), (cnt_a, cnt_b)


def _random_words(device, seed: int):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=device,
                             generator=gen)
    return words


def phase_doctor():
    """The port's ``doctor`` runtime check on the card (the native library,
    torch and its CUDA, the card, nvcc, and every kernel source through
    ``build_cuda_library``, a cache hit after phase 1); fails on any problem
    line.  The external tools are phase 10's to report.  Then the plotting
    packages, which the port imports only inside ``plot``."""
    import importlib.metadata
    import importlib.util

    from tracs_tpu_torch.stages.doctor import check_runtime

    ok, problems = check_runtime("cuda")
    for line in ok:
        print(f"# doctor:   ok  {line}")
    for line in problems:
        print(f"# doctor: FAIL  {line}")
    if problems:
        fail(f"doctor found {len(problems)} problem(s) on the card: {problems[0]}")
    for package in ("matplotlib", "pandas"):
        found = importlib.util.find_spec(package) is not None
        print(f"# {package}: {importlib.metadata.version(package) if found else 'absent'}")


#: name, A rows, B rows (None: self), W, r0, rb, c0
KERNEL_CASES = [
    ("ragged n=37 W=17", 37, None, 17, 0, 37, 0),
    ("rectangle 37x11 r0=5 c0=3", 48, 14, 17, 5, 37, 3),
    ("ragged n=300 W=1001 r0=100 rb=150 c0=29", 300, None, 1001, 100, 150, 29),
    ("main path rb=1024 n=4096 W=31250", 4096, None, 31250, 0, 1024, 0),
]


def sweep_blocks(kname: str, call, plain, splits_attr: str, n: int, W: int, row_block: int,
                 card, check, **work):
    """A gram kernel at every row block of the main path's sweep (rows
    [r0, r0 + rb) against the column suffix [r0, n)): ``call(r0, rb)`` exact
    against ``plain(r0, rb)``, the median ms with the launcher's own cut of
    the word axis and with the cut forced off (``splits_attr`` of ops/kernels
    set to 1).  ``work`` goes to ``gram_bound``.  Returns one record per
    block."""
    import torch

    from tracs_tpu_torch.ops import kernels

    blocks = []
    for r0 in range(0, n, row_block):
        rb, m = min(row_block, n - r0), n - r0
        name = f"sweep block r0={r0} rb={rb} m={m} W={W}"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(r0, rb)
        end.record()
        got = call(r0, rb)
        torch.cuda.synchronize()
        check(kname, name, got, want)
        del got, want
        ms = time_ms(lambda: call(r0, rb), 10)
        setattr(kernels, splits_attr, 1)
        try:
            whole_ms = time_ms(lambda: call(r0, rb), 10)
        finally:
            setattr(kernels, splits_attr, 0)
        rec = {"m": m, "ms": ms, "whole_tiles_ms": whole_ms, "plain_ms": start.elapsed_time(end),
               **gram_bound(f"{kname} at {name}", n, None, W, r0, rb, r0, card=card,
                            peak_ops=PEAK_B1, **work)}
        print(f"# {kname} at {name}: kernel {ms:.3f} ms, with the word axis uncut "
              f"{whole_ms:.3f} ms, plain {rec['plain_ms']:.3f} ms (one run), "
              f"{100 * rec['bound_ms'] / ms:.1f}% of the bound")
        blocks.append(rec)
    return blocks


def phase_kernels(device, seed: int, card):
    """Each gram kernel against its plain version on the card at
    KERNEL_CASES.  K1 and the tensor-core variants run on the same inputs;
    the variants of one operand type share its plain version, and K1 shares
    the b1 one.  Returns {kernel: {max_abs_err (of each output), ms,
    plain_ms, bound_ms, bound_by}}, the times and bounds at the main-path
    shape; K1's and ``popcount_gram``'s records also hold ``sweep_blocks``,
    their four blocks of the main path's sweep."""
    from functools import partial

    import torch

    from tracs_tpu_torch.ops import kernels

    words = _random_words(device, seed)
    split_fns = {"split_gram": (kernels.split_gram, "b1")}
    for dot, tile, unpack in kernels.SPLIT_GRAM_VARIANTS:
        split_fns[kernels.variant_name(dot, tile, unpack)] = (
            partial(kernels.split_gram_variant, dot=dot, tile=tile, unpack=unpack), dot)
    plains = {dot: partial(kernels.split_gram_variant_reference, dot=dot)
              for dot in ("b1", "s8", "bf16")}
    out = {name: {"max_abs_err": [0, 0]} for name in (*split_fns, "popcount_gram")}

    def check(kname, name, got, want):
        err = [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)]
        out[kname]["max_abs_err"] = [max(e, f) for e, f in zip(out[kname]["max_abs_err"], err)]
        print(f"# {kname} vs plain, {name}: out {tuple(got[0].shape)}, max |err| {err}")
        if any(err):
            fail(f"{kname} disagrees with its plain version at {name}")

    for name, na, nb, W, r0, rb, c0 in KERNEL_CASES:
        timed = name.startswith("main path")
        b = (None, None) if nb is None else kernels.pad_layout(words(nb, 4, W), words(nb, W))
        args = kernels.pad_layout(words(na, 4, W), words(na, W)) + (r0, rb, c0) + b
        want, plain_ms = {}, {}
        for dot, plain in plains.items():
            want[dot] = plain(*args)
            if timed:
                plain_ms[dot] = time_ms(lambda: plain(*args), 3)
        for kname, (fn, dot) in split_fns.items():
            got = fn(*args)
            torch.cuda.synchronize()
            check(kname, name, got, want[dot])
            if timed:
                ms = time_ms(lambda: fn(*args), 10)
                print(f"# {kname} at {name}: kernel {ms:.3f} ms, plain ({dot}) "
                      f"{plain_ms[dot]:.3f} ms (median)")
                out[kname].update(ms=ms, plain_ms=plain_ms[dot], **gram_bound(
                    f"{kname} at {name}", na, nb, W, r0, rb, c0, planes=5, products=5,
                    popc=5, card=card,
                    peak_ops=PEAK_BY_DOT[dot]))
        del got, want
        if timed:
            ea, nm = args[:2]
            out["split_gram"]["sweep_blocks"] = sweep_blocks(
                "split_gram", lambda r0, rb: kernels.split_gram(ea, nm, r0, rb, r0),
                lambda r0, rb: plains["b1"](ea, nm, r0, rb, r0), "_SPLIT_GRAM_WORD_SPLITS",
                na, W, ROW_BLOCK, card, check, planes=5, products=5, popc=5)
            lib_ms, unpack_s, lib = library_split_gram(ea, nm, r0, rb, c0)
            got = kernels.split_gram(ea, nm, r0, rb, c0)
            if not all(torch.equal(x, y) for x, y in zip(got, lib)):
                fail(f"torch._int_mm's G4 - Gn and Gn differ from split_gram's at {name}")
            out["split_gram"]["library_ms"] = lib_ms
            print(f"# split_gram at {name}: torch._int_mm G4 + Gn {lib_ms:.3f} ms (int8 operands "
                  f"unpacked beforehand in {unpack_s:.2f} s, not counted), equal to the "
                  f"kernel's; kernel {out['split_gram']['ms']:.3f} ms")
            del ea, nm, got, lib
        del args, b
        torch.cuda.empty_cache()

        # the raw planes at the card's pitch, as ops/pairsnp.py uploads them
        args = (kernels.pad_planes(words(na, 4, W)), r0, rb, c0,
                None if nb is None else kernels.pad_planes(words(nb, 4, W)))
        got = kernels.popcount_gram(*args)
        torch.cuda.synchronize()
        check("popcount_gram", name, got, kernels.popcount_gram_reference(*args))
        if timed:
            ms = time_ms(lambda: kernels.popcount_gram(*args), 10)
            plain = time_ms(lambda: kernels.popcount_gram_reference(*args), 3)
            print(f"# popcount_gram at {name}: kernel {ms:.3f} ms, plain {plain:.3f} ms (median)")
            # as a matrix product the two counts are 15 bit-products, the 15
            # plane subsets of the inclusion-exclusion: the N gram that nunion
            # needs is the 4-plane subset's gram, not a 16th
            work = dict(planes=4, products=15, popc=2)
            out["popcount_gram"].update(ms=ms, plain_ms=plain, **gram_bound(
                f"popcount_gram at {name}", na, nb, W, r0, rb, c0, card=card,
                peak_ops=PEAK_B1, **work))
            pa = args[0]
            out["popcount_gram"]["sweep_blocks"] = sweep_blocks(
                "popcount_gram", lambda r0, rb: kernels.popcount_gram(pa, r0, rb, r0),
                lambda r0, rb: kernels.popcount_gram_reference(pa, r0, rb, r0),
                "_POPCOUNT_GRAM_WORD_SPLITS", na, W, ROW_BLOCK, card, check, **work)
            lib_ms, unpack_s, (matches, gn), (cnt_a, cnt_b) = library_popcount_gram(
                pa, r0, rb, c0, kernels._SUBSET_SIGNS)
            lib = (matches, cnt_a[:, None] + cnt_b[None, :] - gn)
            if not all(torch.equal(x.long(), y.long()) for x, y in zip(got, lib)):
                fail(f"torch._int_mm's signed subset gram and N gram differ from "
                     f"popcount_gram's (matches, nunion) at {name}")
            out["popcount_gram"]["library_ms"] = lib_ms
            print(f"# popcount_gram at {name}: torch._int_mm signed 15-subset gram + N gram "
                  f"{lib_ms:.3f} ms (over word chunks; int8 operands unpacked beforehand in "
                  f"{unpack_s:.2f} s, not counted), equal to the kernel's; kernel {ms:.3f} ms")
            del pa, matches, gn, lib
        del args, got
        torch.cuda.empty_cache()
    out.update(block_kernels(device, seed, card))
    out.update(layout_kernels(device, seed))
    return out


#: the layout kernels' cases: (samples, words), below, at and past the card's
#: pitch of 4 words and across the layout kernel's groups of 32 samples and
#: chunks of 1,024 words; then the main path's alignment
LAYOUT_CASES = [(1, 1), (33, 5), (65, 1030), (129, 2051)]


def layout_kernels(device, seed: int) -> dict:
    """``split_layout`` and ``split_gather`` (the split layout built on the
    card from the uploaded raw planes, and its partial planes) against their
    plain versions on the card, exact, on random words (every bit pattern:
    all-N, partial and empty sites) at LAYOUT_CASES and at the main path's
    4,096 samples x 31,250 words, where both are timed on the card alone
    (``device_ms``) beside the plain versions and their bounds: the layout
    pass reads each plane word once and writes excl and nmask at the card's
    pitch once; the gather reads each partial site's word a plane row and
    writes the partial planes, at the headline's 2,048 sites.  Returns
    {kernel: {max_abs_err, ms, device_ms, plain_ms, bound_ms, bound_by}}."""
    import torch

    from tracs_tpu_torch.ops import kernels

    words = _random_words(device, seed + 7)
    rng = np.random.default_rng(seed)
    out = {"split_layout": {"max_abs_err": [0, 0, 0, 0]}, "split_gather": {"max_abs_err": [0]}}

    def check(kname, name, got, want):
        err = [int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want)]
        out[kname]["max_abs_err"] = [max(e, f) for e, f in zip(out[kname]["max_abs_err"], err)]
        print(f"# {kname} vs plain, {name}: max |err| {err}")
        if any(err) or any(g.shape != w.shape for g, w in zip(got, want)):
            fail(f"{kname} disagrees with its plain version at {name}")

    for n, W in [*LAYOUT_CASES, (MAIN_N, 31250)]:
        name = f"n={n} W={W}"
        timed = n == MAIN_N
        planes = words(n, 4, W)
        got = kernels.split_layout(planes)
        torch.cuda.synchronize()
        check("split_layout", name, got, kernels.split_layout_reference(planes))
        P = 2048 if timed else min(97, 32 * W)
        pos = np.sort(rng.choice(32 * W, size=P, replace=False)).astype(np.int64)
        part = kernels.split_gather(got[0], pos)
        torch.cuda.synchronize()
        check("split_gather", name, (part,), (kernels.split_gather_reference(got[0], pos),))
        if timed:
            pitch = got[0].shape[2]
            layout_bytes = n * 4 * W * 4 + n * 5 * pitch * 4 + n * 4 + W * 4
            gather_bytes = n * 4 * P * 4 + part.numel() * 4 + P * 8
            for kname, fn, plain, nbytes in (
                    ("split_layout", lambda: kernels.split_layout(planes),
                     lambda: kernels.split_layout_reference(planes), layout_bytes),
                    ("split_gather", lambda: kernels.split_gather(got[0], pos),
                     lambda: kernels.split_gather_reference(got[0], pos), gather_bytes)):
                ms, dev_ms = time_ms(fn, 10), device_ms(fn, 10)
                plain_ms = time_ms(plain, 3)
                bound_ms, by = bound(nbytes, 0, 1)
                out[kname].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=by)
                print(f"# {kname} at {name} ({P} partial sites): a call {ms:.3f} ms, card "
                      f"{dev_ms:.3f} ms, plain {plain_ms:.3f} ms (median); bound {bound_ms:.3f} "
                      f"ms by {by} ({nbytes / 1e9:.3f} GB), {100 * bound_ms / dev_ms:.1f}% "
                      f"of it on the card")
            for k, kname in enumerate(("split_layout", "split_gather")):
                out[kname].update(build_facts("split_layout", k))
        del planes, got, part
        torch.cuda.empty_cache()
    return out


#: the main path's sweep at the headline: row block, samples, and the words
#: of its 2048 partial-IUPAC sites
MAIN_RB, MAIN_N, MAIN_WP = ROW_BLOCK, 4096, 64
#: the synthetic blocks of ``coo_extract``: sites, and the bound of D, which is
#: uniform below it, so that ~0.5% of the pairs lie within 200, as the
#: headline's clusters of 21 in 4096 samples do
COO_L, COO_DMAX = 1_000_000, 40_000
INT32_MAX = 2**31 - 1


def coo_needed(rb: int, m: int, r0: int, c0: int, n_valid: int, triangle: bool) -> int:
    """Pairs of a block that the extraction has to look at: the columns below
    ``n_valid`` and, on a triangle block, above the row."""
    hi = min(m, max(0, n_valid - c0))
    lo = np.maximum(0, r0 + np.arange(rb) - c0 + 1) if triangle else np.zeros(rb, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def build_facts(name: str, *variant) -> dict:
    """Registers a thread, local memory a thread (spills) and shared memory a
    block of the built kernel ``csrc/<name>.cu`` (its variant ``variant``),
    from ``cudaFuncGetAttributes`` through the library's own entry point."""
    import ctypes

    from tracs_tpu_torch.runtime.build import load_cuda_library

    fn = getattr(load_cuda_library(name), f"tracs_{name}_attributes")
    vals = [ctypes.c_int() for _ in range(3)]
    rc = fn(*variant, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        fail(f"{name}: cudaFuncGetAttributes failed with CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "shared_bytes"), (v.value for v in vals)))


def block_kernels(device, seed: int, card):
    """``partial_gram`` and ``coo_extract`` against their plain versions on
    the card, exact, at ragged shapes and at the main path's blocks: the
    headline's first block (rb=1024 x m=4096, 2048 partial sites) and the
    other three suffix widths of its sweep (m = 3072, 2048, 1024); for
    ``partial_gram`` also partial planes of unpadded word counts brought to
    the card's pitch by ``pad_planes`` (against the plain version on the
    unpadded words); for
    ``coo_extract`` also a mesh slab whose last columns lie past n_valid, the
    three ways the engines call it (split with the correction gram, split
    without it as the mesh does, direct as the popcount engine does) and the
    thresholds -1, 0, 200 and 2^31 - 1, where the output sized on the host
    (``coo_capacity``) must be exactly filled.  The grams of ``coo_extract``
    are synthetic, with D uniform below ``COO_DMAX``.  Returns the records of
    ``partial_gram`` and of the three ways of ``coo_extract`` at the first
    block (dist 200), each kernel's error pooled over its cases, with the
    build facts of the kernel on the path."""
    import torch

    from tracs_tpu_torch.ops import kernels

    words = _random_words(device, seed + 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, dtype=torch.int32, device=device, generator=gen)

    out = {}
    n, rb, Wp = MAIN_N, MAIN_RB, MAIN_WP
    rec = out["partial_gram"] = {"max_abs_err": 0, **build_facts("partial_gram")}
    print(f"# partial_gram: {rec['registers']} registers, {rec['local_bytes']} B local, "
          f"{rec['shared_bytes']} B shared")
    pt = words(n, 4, Wp)
    # unpadded word counts, brought to the card's pitch as the layouts are;
    # the plain version runs on the unpadded words
    cases = [(f"ragged {na}x{nb} Wp={w} (padded to {kernels.padded_words(w)})", None,
              words(na, 4, w), words(nb, 4, w))
             for na, nb, w in ((37, 11, 3), (300, 129, 1), (65, 100, 100), (rb, n, 61))]
    cases += [(f"sweep block r0={r0} rb={rb} m={n - r0} Wp={Wp}", r0, pt[r0:r0 + rb], pt[r0:])
              for r0 in range(0, n, rb)]
    for name, r0, a, b in cases:
        pa, pb = kernels.pad_planes(a), kernels.pad_planes(b)
        got = kernels.partial_gram(pa, pb)
        torch.cuda.synchronize()
        want = kernels.partial_gram_reference(a, b)
        err = int((got.long() - want.long()).abs().max())
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"# partial_gram vs plain, {name}: out {tuple(got.shape)}, max |err| {err}")
        if err:
            fail(f"partial_gram disagrees with its plain version at {name}")
        del got, want
        if r0 is None:
            continue
        ms = time_ms(lambda: kernels.partial_gram(pa, pb), 10)
        alone = device_ms(lambda: kernels.partial_gram(pa, pb))
        bound_rec = gram_bound(f"partial_gram at {name}", n, None, Wp, r0, rb, r0, planes=4,
                               products=10, popc=2, card=card, peak_ops=PEAK_B1, outputs=1)
        if r0 == 0:
            lib_ms, unpack_s, lib = library_partial_gram(pa, pb)
            if not torch.equal(lib, kernels.partial_gram(pa, pb)):
                fail(f"torch._int_mm's signed product differs from partial_gram's at {name}")
            print(f"# partial_gram at {name}: torch._int_mm {lib_ms:.4f} ms (int8 operands "
                  f"unpacked beforehand in {unpack_s:.3f} s, not counted), equal to the kernel's")
            del lib
            rec.update(ms=ms, device_ms=alone, library_ms=lib_ms,
                       plain_ms=time_ms(lambda: kernels.partial_gram_reference(a, b), 3),
                       **bound_rec)
            print(f"# partial_gram at {name}: kernel {ms:.3f} ms (on the card alone "
                  f"{alone:.4f} ms), plain {rec['plain_ms']:.3f} ms (median; float64 unpack "
                  f"and mm, the port's route before the kernels)")
        else:
            print(f"# partial_gram at {name}: kernel {ms:.3f} ms; on the card alone "
                  f"{alone:.4f} ms")
    del pt, cases
    torch.cuda.empty_cache()

    L = COO_L

    def grams(rb, m, way):
        D = ints(0, COO_DMAX, rb, m)
        if way == "direct":
            return {"mode": "direct", "g": L - D, "gn": ints(0, L, rb, m)}
        cnt_a, cnt_b = ints(0, 1000, rb), ints(0, 1000, m)
        gp = ints(-64, 1, rb, m) if way == "split+gp" else None
        g = L - D - cnt_a[:, None] - cnt_b[None, :] - (0 if gp is None else gp)
        return {"mode": "split", "g": g, "gn": ints(0, L // 2, rb, m), "gp": gp,
                "cnt_a": cnt_a, "cnt_b": cnt_b}

    ways = {"split+gp": "coo_extract", "split": "coo_extract (split)",
            "direct": "coo_extract (direct)"}
    for way, kname in ways.items():
        facts = build_facts("coo_extract", int(way != "direct"), int(way == "split+gp"))
        print(f"# {kname}: {facts['registers']} registers, {facts['local_bytes']} B local, "
              f"{facts['shared_bytes']} B shared")
        out[kname] = {"max_abs_err": 0, **facts}
    cases = []  # (name, way, rb, m, r0, c0, n_valid, triangle, dists, timed)
    for way in ways:
        cases.append((f"main path block rb={rb} m={n}, {way}", way, rb, n, 0, 0, n, True,
                      (-1, 0, 200, INT32_MAX), True))
    cases += [(f"sweep block r0={r0} rb={rb} m={n - r0}, split+gp", "split+gp", rb, n - r0, r0,
               r0, n, True, (200,), True) for r0 in range(rb, n, rb)]
    cases += [
        (f"mesh slab rb={rb} m=2048 r0=1024 c0=2048 n_valid=4000, triangle {tri}", "split",
         rb, 2048, 1024, 2048, 4000, tri, (200, INT32_MAX), False) for tri in (False, True)]
    cases += [("ragged rb=37 m=1500 r0=5 c0=3 n_valid=1400", "split+gp", 37, 1500, 5, 3, 1400,
               True, (-1, 200, INT32_MAX), False),
              ("1 x 1", "direct", 1, 1, 0, 1, 2, True, (INT32_MAX,), False)]
    for name, way, rb_, m, r0, c0, n_valid, tri, dists, timed in cases:
        gr = grams(rb_, m, way)
        kname = ways[way]
        rec = out[kname]
        for dist in dists:
            kw = dict(L=L, dist=dist, r0=r0, c0=c0, n_valid=n_valid, triangle=tri)
            got = kernels.coo_extract(**gr, **kw)
            torch.cuda.synchronize()
            want = kernels.coo_extract_reference(**gr, **kw)
            if got.shape != want.shape:
                fail(f"coo_extract at {name}, dist {dist}: {tuple(got.shape)} pairs against the "
                     f"plain version's {tuple(want.shape)}")
            need = coo_needed(rb_, m, r0, c0, n_valid, tri)
            if kernels.coo_capacity(rb_, m, r0, c0, n_valid, tri) != need or (
                    dist == INT32_MAX and got.shape[1] != need):
                fail(f"coo_extract at {name}, dist {dist}: {got.shape[1]} pairs kept, capacity "
                     f"{kernels.coo_capacity(rb_, m, r0, c0, n_valid, tri)}, {need} in range")
            err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            print(f"# {kname} vs plain, {name}, dist {dist}: {got.shape[1]} pairs, max |err| "
                  f"{err}")
            if err:
                fail(f"coo_extract disagrees with its plain version at {name}, dist {dist}")
            if not (timed and dist == 200):
                continue
            ms = time_ms(lambda: kernels.coo_extract(**gr, **kw), 10)
            alone = device_ms(lambda: kernels._coo_launch(
                gr["g"], gr["gn"], gr["mode"], L, dist, r0, c0, n_valid, tri, gr.get("gp"),
                gr.get("cnt_a"), gr.get("cnt_b")))
            plain_ms = time_ms(lambda: kernels.coo_extract_reference(**gr, **kw), 3)
            k = got.shape[1]
            # each needed pair's g (and gp) once, each survivor's gn once and
            # its 16 bytes out, the N counts; about 6 integer operations a pair
            moved = need * 4 * (2 if way == "split+gp" else 1) + k * 20 + (rb_ + m) * 4
            ms_b, by = bound(moved, 6 * need, PEAK_CUDA_CORE)
            print(f"# {kname} at {name}: kernel {ms:.3f} ms (its one launch and its wait for "
                  f"the total; the launch alone on the card {alone:.4f} ms), plain "
                  f"{plain_ms:.3f} ms (median; the port's route before this "
                  f"kernel: D/NN assembled, masks, torch.nonzero, gathers); bound {ms_b:.4f} ms "
                  f"by {by} ({need} pairs looked at, {k} kept)")
            if r0 == 0:
                rec.update(ms=ms, device_ms=alone, plain_ms=plain_ms, bound_ms=ms_b, bound_by=by)
            del got, want
        del gr
        torch.cuda.empty_cache()
    return out


def _headline(n: int, L: int, seed: int, tmp: str):
    """(packed alignment, FASTA path, cluster size) of the headline workload."""
    cluster_size = max(6, round(0.005 * n) + 1)
    from tracs_tpu_torch.experiments.workload import make_clustered
    from tracs_tpu_torch.io.fasta import write_fasta

    t0 = time.perf_counter()
    packed = make_clustered(n, L, cluster_size=cluster_size, seed=seed)
    fasta = os.path.join(tmp, "clustered.fasta")
    write_fasta(fasta, fasta_records(packed))
    print(f"# workload: n={n} L={L} clusters of {cluster_size}, FASTA "
          f"{os.path.getsize(fasta) / 1e9:.2f} GB written in {time.perf_counter() - t0:.1f} s")
    return packed, fasta, cluster_size


def _run_cli(argv, n: int, row_block: int, what: str, device):
    """One ``distance`` CLI run with the launch counts set to 0 just before
    it and read just after; returns (wall s, the counts, CSV rows as field
    lists, sha256)."""
    import torch

    from tracs_tpu_torch import cli

    reset_counts()
    t0 = time.perf_counter()
    cli.main(argv + ["--device", device.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_blocks = -(-n // row_block)
    print(f"# {what}: {wall:.3f} s wall, split_gram launches {counts['split_gram']} for "
          f"{n_blocks} row blocks, partial_gram launches {counts['partial_gram']}, "
          f"coo_extract launches {counts['coo_extract']}, popcount_gram launches "
          f"{counts['popcount_gram']}, mism_positions launches {counts['mism_positions']}")
    # the headline has partial-IUPAC columns: every split block needs the correction gram
    for name in ("split_gram", "partial_gram", "coo_extract"):
        if counts[name] != n_blocks:
            fail(f"{what}: {counts[name]} {name} launches for {n_blocks} row blocks")
    with open(argv[argv.index("-o") + 1], "rb") as fh:
        data = fh.read()
    fields = [ln.split(",") for ln in data.decode().splitlines()[1:]]
    return wall, counts, fields, hashlib.sha256(data).hexdigest()


def phase_slice(packed, fasta: str, cluster_size: int, row_block: int, seed: int, tmp: str,
                device):
    """The distance stage through the CLI entry point; returns (every
    kernel's launches in that run, CSV rows, the CSV's sha256)."""
    n, L = packed.n_seqs, packed.length
    out = os.path.join(tmp, "dists.csv")
    argv = ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block", str(row_block)]
    wall, counts, fields, sha = _run_cli(argv, n, row_block, "distance CLI", device)
    i = np.array([int(f[0]) for f in fields], dtype=np.int64)
    j = np.array([int(f[1]) for f in fields], dtype=np.int64)
    sizes = np.bincount(np.arange(n) // cluster_size)
    expected = int((sizes * (sizes - 1) // 2).sum())
    pairs = n * (n - 1) // 2
    print(f"# CSV: {len(fields)} rows (within-cluster pairs: {expected}), sha256 {sha}")
    print(f"# slice: {pairs / wall:,.0f} pairs/s over the CLI wall time ({pairs} pairs)")
    if len(fields) != expected or not np.all(i // cluster_size == j // cluster_size):
        fail("the CSV does not hold exactly the within-cluster pairs")
    if not np.all(i < j):
        fail("the CSV holds pairs outside the upper triangle")
    if (counts["split_layout"], counts["split_gather"]) != (1, 1):
        fail(f"distance CLI: the split layout took {counts['split_layout']} layout and "
             f"{counts['split_gather']} gather launches; the card builds it once")

    rng = np.random.default_rng(seed)
    pick = rng.choice(len(fields), size=min(2000, len(fields)), replace=False)
    d_csv = np.array([int(fields[k][3]) for k in pick])
    nn_csv = np.array([int(fields[k][7]) for k in pick])
    d_ref, nn_ref = oracle(packed.planes, L, i[pick], j[pick])
    if not (np.array_equal(d_csv, d_ref) and np.array_equal(nn_csv, nn_ref)):
        fail("sampled CSV rows disagree with the host popcount oracle")
    print(f"# oracle: {len(pick)} sampled rows agree (SNP distance and sites considered)")
    return counts, fields, sha


#: timed sweeps of the bench phase (after its two warm-ups)
BENCH_ITERS = 5


def phase_bench(packed, rows: int, device):
    """The headline bench's timed sweeps (``bench_gpu`` of
    ``tracs_tpu_torch.experiments.bench``, ``--method split``) on the
    headline's alignment, its result printed (the entry point's full line
    adds ``vs_baseline``, a numpy CPU rate this phase does not need): its
    survivors must equal the distance CLI run's rows, and ``split_gram``,
    ``partial_gram`` and ``coo_extract`` must each launch once a row block in
    each of its sweeps (two warm-ups and ``BENCH_ITERS`` timed).  The bench's
    resident layout then leaves the card.  Returns every kernel's launches in
    the bench."""
    import torch

    from tracs_tpu_torch.experiments import bench

    reset_counts()
    line = bench.bench_gpu(packed=packed, method="split", device=device, iters=BENCH_ITERS)
    counts = read_counts()
    print(f"# bench (tracs_tpu_torch.experiments.bench.bench_gpu, --method split): "
          f"{json.dumps(line)}")
    n_blocks = -(-packed.n_seqs // bench.default_row_block(packed.n_seqs))
    want = (2 + BENCH_ITERS) * n_blocks
    print(f"# bench launches: split_gram {counts['split_gram']}, partial_gram "
          f"{counts['partial_gram']}, coo_extract {counts['coo_extract']} for "
          f"{2 + BENCH_ITERS} sweeps of {n_blocks} row blocks")
    for name in ("split_gram", "partial_gram", "coo_extract"):
        if counts[name] != want:
            fail(f"bench: {counts[name]} {name} launches for {2 + BENCH_ITERS} sweeps of "
                 f"{n_blocks} row blocks")
    if line["survivors"] != rows:
        fail(f"bench: {line['survivors']} survivors, the distance CLI run wrote {rows} rows")
    del packed._split_cache
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_transcluster_bench(device):
    """The transmission-model bench
    (``tracs_tpu_torch.experiments.transcluster_bench``) on its synthetic mix
    (250,000 rows): three cold lookups and a memoised one, its JSON line
    printed."""
    from tracs_tpu_torch.experiments import transcluster_bench as tcb

    snp, dd, source = tcb.load_mix(None)
    line = tcb.bench(snp, dd, device=device)
    print(f"# transcluster bench ({source}): {json.dumps(line)}")


def pair_pattern(name: str, rng, n: int):
    """Pair lists as the filter and other callers may send them (the card
    tests' patterns): runs of one first sample, one run longer than a tile,
    a single pair, pairs in no order, every sample against itself."""
    if name == "runs":
        return np.repeat(np.arange(n // 2), 5), np.tile(np.arange(n // 2, n // 2 + 5), n // 2)
    if name == "long run":
        return np.full(600, 2), rng.integers(0, n, size=600)
    if name == "one":
        return np.array([3]), np.array([n - 1])
    if name == "unsorted":
        return rng.integers(0, n, size=333), rng.integers(0, n, size=333)
    return np.arange(n), np.arange(n)


PAIR_PATTERNS = ("runs", "long run", "one", "unsorted", "self")


def phase_mism_positions(packed, block, device):
    """``mismatch_positions_kernel`` against its plain version on the layouts
    the sweeps left resident: the pairs of one emitted row block at the
    capacity the filter gives it, through the kernel the wrapper's rule
    picks there (the tiled kernel: the run fails otherwise), timed a call
    and on the card alone beside the first version (the warp kernel, forced)
    and the rule's host part; then a ragged length with a capacity below
    some counts, and the five pair patterns over the first 64 samples through
    both kernels, forced, each through the split layout and the raw planes.
    Returns the kernel's record for the JSON line."""
    import torch

    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.pairsnp import (_cached_compact, _planes_device, _split_device,
                                             _split_pair)

    comp = _cached_compact(packed, packed)
    a_k = packed if comp is None else comp[0]
    ea, nm, _ = _split_device(_split_pair(a_k, None, device)[0], device)
    raw = _planes_device(a_k, device)
    n, L, W = a_k.n_seqs, a_k.length, ea.shape[2]
    if raw.shape[2] != W or W % kernels.LAYOUT_WORD_MULTIPLE:
        fail(f"the resident raw planes have {raw.shape[2]} words a row and the split layout "
             f"{W}: both should carry the card's pitch")
    rows, cols, dvals = block[3], block[4], block[5]
    todo = dvals > 1
    # the pair indices as the filter passes them: numpy on the host
    ii, jj = rows[todo].astype(np.int64), cols[todo].astype(np.int64)
    # ops/recomb.py::filter_pairs: the power of two at or above the largest d, at least 128
    cap = 1 << max(7, int(np.ceil(np.log2(max(2, int(dvals.max()))))))
    far = np.arange(min(16, n // 2))
    ii2, jj2 = np.concatenate([ii[:2000], far]), np.concatenate([jj[:2000], n - 1 - far])
    main = (ea, None, ii, jj, L, cap, nm, None)
    cases = [(f"main path P={len(ii)} W={W} capacity={cap}, split layout", None, main),
             (f"ragged L={L - 13} capacity=64 P={len(ii2)}, split layout", None,
              (ea, None, ii2, jj2, L - 13, 64, nm, None)),
             (f"ragged L={L - 13} capacity=64 P={len(ii2)}, raw planes at pitch {raw.shape[2]}",
              None, (raw, None, ii2, jj2, L - 13, 64))]
    rng = np.random.default_rng(7)
    for pattern in PAIR_PATTERNS:
        pi, pj = pair_pattern(pattern, rng, 64)
        for design in ("tiled", "warp"):
            cases += [(f"pattern {pattern!r}, P={len(pi)}, {design} kernel, split layout", design,
                       (ea, None, pi, pj, L - 5, 256, nm, None)),
                      (f"pattern {pattern!r}, P={len(pi)}, {design} kernel, raw planes", design,
                       (raw, None, pi, pj, L - 5, 256))]
    rec = {"max_abs_err": 0, **build_facts("mism_positions", 1)}
    print(f"# mism_positions (tiled, split layout): {rec['registers']} registers, "
          f"{rec['local_bytes']} B local, {rec['shared_bytes']} B static shared")
    for k, (name, design, args) in enumerate(cases):
        before = launches("mism_positions_tiled")
        got = kernels.mismatch_positions_kernel(*args, _design=design)
        torch.cuda.synchronize()
        tiled = launches("mism_positions_tiled") - before
        want = kernels.mismatch_positions_reference(*args)
        err = int((got.long() - want.long()).abs().max())
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        counts = got[:, 0]
        print(f"# mism_positions vs plain, {name}: table {tuple(got.shape)}, counts "
              f"{int(counts.min())}..{int(counts.max())}, max |err| {err}")
        if err:
            fail(f"mism_positions disagrees with its plain version at {name}")
        if k == 0:
            if not tiled:
                fail("the wrapper's rule did not take the tiled kernel at the main path's block")
            if not np.array_equal(counts.cpu().numpy(), dvals[todo]):
                fail("mism_positions counts differ from the sweep's distances")
            rec.update(timed_mism_positions(main, name, W))
        elif k < 3 and not (int(counts.min()) < 64 < int(counts.max())):
            fail(f"{name}: the capacity is not below some counts and above others")
        del got, want
    return rec


def timed_mism_positions(args, name: str, W: int) -> dict:
    """Times of ``mismatch_positions_kernel`` at the main path's block: the
    tiled kernel (the rule's choice) and the warp kernel (the first version,
    forced) in turns (tiled, warp, warp, tiled), each a call (CUDA events
    around the wrapper: the tile plan and the allocations included) and on
    the card alone (``device_ms`` on a prepared launcher); the rule's host
    part (``mism_design``: the plan) on the host's clock; the plain version;
    and the bound.  Every launch here is a timing launch."""
    import torch

    from tracs_tpu_torch.ops import kernels

    times = {"tiled": [], "warp": []}
    tables = {}
    for design in ("tiled", "warp", "warp", "tiled"):
        force = None if design == "tiled" else design   # the tiled kernel by the rule, as the path
        call = time_ms(lambda: kernels.mismatch_positions_kernel(*args, _design=force), 10)
        out, _, launch = kernels._mism_launcher(*args, design=force)
        alone = device_ms(launch)
        times[design].append((call, alone))
        tables[design] = out
    # the first version's table is the new one's, so the filter's output is too
    if not torch.equal(tables["tiled"], tables["warp"]):
        fail(f"{name}: the tiled and the warp kernel give different tables")
    t0 = time.perf_counter()
    for _ in range(5):
        kernels.mism_design((args[0], args[6]), W, args[2], args[3], args[5], True)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    plain_ms = time_ms(lambda: kernels.mismatch_positions_reference(*args), 2)
    for design, runs in times.items():
        print(f"# mism_positions at {name}: {design} kernel a call "
              f"{', '.join(f'{c:.3f}' for c, _ in runs)} ms, on the card alone "
              f"{', '.join(f'{a:.4f}' for _, a in runs)} ms")
    print(f"# mism_positions at {name}: the rule's host part (the tile plan) {host_ms:.3f} ms; "
          f"plain {plain_ms:.3f} ms (median)")
    rows, cols, cap = args[2], args[3], args[5]
    P = len(rows)
    used = len(np.unique(np.concatenate([rows, cols])))
    out_bytes = P * (1 + cap) * 4
    # each referenced sample's 5 rows read once, the pair list, the table
    # written once, against ~12 integer operations a word of a pair
    ms_b, by = bound(used * 5 * W * 4 + 16 * P + out_bytes, 12 * P * W, PEAK_CUDA_CORE)
    tiled = float(np.median([a for _, a in times["tiled"]]))
    print(f"# bound of mism_positions at {name}: {ms_b:.3f} ms by {by} ({used} distinct "
          f"samples read once): {100 * ms_b / tiled:.1f}% of the tiled kernel's card time; "
          f"every pair's 10 words per 32 sites from device memory would take "
          f"{(P * 10 * W * 4 + out_bytes) / PEAK_BYTES * 1e3:.3f} ms")
    return {"ms": float(np.median([c for c, _ in times["tiled"]])), "device_ms": tiled,
            "plain_ms": plain_ms, "bound_ms": ms_b, "bound_by": by, "host_plan_ms": host_ms,
            "first_version_ms": float(np.median([c for c, _ in times["warp"]])),
            "first_version_device_ms": float(np.median([a for _, a in times["warp"]]))}


def phase_sweeps(fasta: str, row_block: int, device, card):
    """pairsnp_stream through both engines, cold (fresh alignment object:
    compaction scan, layout and upload) and warm (resident), the warm runs
    taken in turns.  The popcount run is the popcount engine's main path:
    its launch count is read around its cold sweep.  Returns (that count, the
    mismatch-position kernel's record from the resident layouts, the mxu
    route's launches and record)."""
    import torch

    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.packing import PackedAlignment, pack_fasta
    from tracs_tpu_torch.ops.pairsnp import pairsnp_stream

    t0 = time.perf_counter()
    packed = pack_fasta(fasta)
    print(f"# pack_fasta: {time.perf_counter() - t0:.3f} s")
    n_blocks = -(-packed.n_seqs // row_block)

    def sweep(p, method):
        t0 = time.perf_counter()
        blocks = list(pairsnp_stream([p], dist=200, row_block=row_block, device=device,
                                     method=method))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, blocks

    fresh = {m: PackedAlignment(packed.planes, packed.length, packed.names)
             for m in ("split", "popcount")}
    t_split, split_blocks = sweep(fresh["split"], "split")
    reset_counts()
    t_pc, pc_blocks = sweep(fresh["popcount"], "popcount")
    pc_launches = launches("popcount_gram")
    coo_launches = launches("coo_extract")
    print(f"# sweep cold (layout + upload): split {t_split:.3f} s, popcount {t_pc:.3f} s; "
          f"popcount_gram launches {pc_launches}, coo_extract launches {coo_launches}, split_gram "
          f"launches {launches('split_gram')} for {n_blocks} row blocks")
    if pc_launches != n_blocks or coo_launches != n_blocks or launches("split_gram") \
            or launches("partial_gram"):
        fail(f"the popcount sweep made {pc_launches} popcount_gram and {coo_launches} coo_extract "
             f"launches for {n_blocks} row blocks, and {launches('split_gram')} split_gram "
             f"and {launches('partial_gram')} partial_gram launches")
    if len(pc_blocks) != len(split_blocks):
        fail("the popcount and split sweeps yield different numbers of blocks")
    for bp, bs in zip(pc_blocks, split_blocks):
        if bp[:2] != bs[:2] or not all(np.array_equal(x, y) for x, y in zip(bp[3:], bs[3:])):
            fail(f"the popcount sweep disagrees with the split sweep at rows [{bs[0]}, {bs[1]})")
    rows = sum(len(b[3]) for b in pc_blocks)
    print(f"# popcount sweep == split sweep, array for array: {len(pc_blocks)} blocks, "
          f"{rows} pairs")
    warm = {"split": [], "popcount": []}
    for method in ("split", "popcount", "popcount", "split", "split", "popcount"):
        warm[method].append(sweep(fresh[method], method)[0])
    for method, ts in warm.items():
        print(f"# sweep warm {method}: median {float(np.median(ts)):.4f} s of "
              f"{', '.join(f'{t:.4f}' for t in ts)}")
    sweep_by_step(fresh["split"], row_block, device, split_blocks)
    mxu = phase_mxu(fresh["popcount"], split_blocks, row_block, device, card)
    # both engines' layouts of one alignment object: the split layout is
    # resident on fresh["split"]; the raw planes follow at first use
    return ((pc_launches, coo_launches),
            phase_mism_positions(fresh["split"], split_blocks[0], device), mxu)


def sweep_by_step(packed, row_block: int, device, split_blocks, turns: int = 3):
    """The warm split sweep split by step: CUDA events around each call of
    ``split_gram`` (K1), ``partial_gram`` and ``coo_extract_launch`` inside
    ``pairsnp_stream`` (the last one's span holds its one launch; the wait
    for the total comes later, in ``_extract_coo``), summed over the row
    blocks, and the rest of the sweep's host wall (the host copies, ``emit``,
    launch gaps).  Medians over ``turns`` sweeps; each must yield the split
    engine's arrays."""
    import torch

    from tracs_tpu_torch.ops import pairsnp as port

    steps = ("split_gram", "partial_gram", "coo_extract_launch")
    real = {name: getattr(port, name) for name in steps}
    spans = {name: [] for name in steps}

    def timed(name):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    rows = {name: [] for name in (*steps, "rest", "wall")}
    for name in steps:  # only to read the steps' times; the kernels run as always
        setattr(port, name, timed(name))
    try:
        for _ in range(turns):
            for name in steps:
                spans[name].clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blocks = list(port.pairsnp_stream([packed], dist=200, row_block=row_block,
                                              device=device, method="split"))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if len(blocks) != len(split_blocks) or not all(
                    all(np.array_equal(x, y) for x, y in zip(b[3:], s[3:]))
                    for b, s in zip(blocks, split_blocks)):
                fail("the timed split sweep disagrees with the split sweep")
            for name in steps:
                rows[name].append(sum(s.elapsed_time(e) for s, e in spans[name]))
            rows["wall"].append(wall)
            rows["rest"].append(wall - sum(rows[name][-1] for name in steps))
    finally:
        for name, fn in real.items():
            setattr(port, name, fn)
    med = {name: float(np.median(v)) for name, v in rows.items()}
    print(f"# warm split sweep by step (median of {turns}): wall {med['wall']:.3f} ms = K1 "
          f"{med['split_gram']:.3f} + partial_gram {med['partial_gram']:.3f} + coo_extract "
          f"{med['coo_extract_launch']:.3f} + the rest {med['rest']:.3f} ms "
          f"({len(spans['split_gram'])} blocks)")
    return med


def phase_mxu(packed, split_blocks, row_block: int, device, card):
    """``method="mxu"`` on the card, warm on the raw planes the popcount sweep
    left resident: its route is ``popcount_gram`` (g = -matches, gq = cntN_a +
    cntN_b - nunion), launched once a row block, and its arrays must equal the
    split engine's.  Then, at the first block's shape on the headline's own
    planes, the route's (g, gq) against its plain version ``_gram_mxu``.
    Returns the route's record for the JSON line."""
    import torch

    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.pairsnp import (_MXU_SIGNS, _cnt_n, _gram_mxu, _planes_device,
                                             pairsnp_stream)

    n = packed.n_seqs
    n_blocks = -(-n // row_block)
    reset_counts()
    t0 = time.perf_counter()
    blocks = list(pairsnp_stream([packed], dist=200, row_block=row_block, device=device,
                                 method="mxu"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pc_launches = launches("popcount_gram")
    coo_launches = launches("coo_extract")
    print(f"# sweep warm mxu: {wall:.4f} s, popcount_gram launches {pc_launches}, coo_extract "
          f"launches {coo_launches} for {n_blocks} row blocks")
    if pc_launches != n_blocks or coo_launches != n_blocks or launches("split_gram"):
        fail(f"the mxu sweep made {pc_launches} popcount_gram and {coo_launches} coo_extract "
             f"launches for {n_blocks} row blocks")
    if len(blocks) != len(split_blocks) or not all(
            b[:2] == s[:2] and all(np.array_equal(x, y) for x, y in zip(b[3:], s[3:]))
            for b, s in zip(blocks, split_blocks)):
        fail("the mxu sweep disagrees with the split sweep")
    print(f"# mxu sweep == split sweep, array for array: {len(blocks)} blocks")

    pa = _planes_device(packed, device)
    cnt = _cnt_n(packed, 0, None).to(device)
    rb, W = min(row_block, n), pa.shape[2]

    def route():
        matches, nunion = kernels.popcount_gram(pa, 0, rb, 0)
        return -matches, cnt[:rb, None] + cnt[None, :] - nunion

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = _gram_mxu(pa[:rb], pa)  # slow (float64): one run, timed by itself
    end.record()
    got = route()
    torch.cuda.synchronize()
    err = [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)]
    name = f"the headline's block rb={rb} n={n} W={W}"
    print(f"# popcount_gram (mxu route) vs _gram_mxu, {name}: max |err| {err}")
    if any(err):
        fail(f"the mxu route disagrees with its plain version at {name}")
    del got, want
    lib_ms, unpack_s, lib, _ = library_popcount_gram(pa, 0, rb, 0, _MXU_SIGNS)
    got = route()
    if not all(torch.equal(x.long(), y.long()) for x, y in zip(got, lib)):
        fail(f"torch._int_mm's signed subset gram and N gram differ from the mxu route's "
             f"(g, gq) at {name}")
    print(f"# popcount_gram (mxu route) at {name}: torch._int_mm signed 15-subset gram + N gram "
          f"{lib_ms:.3f} ms (over word chunks; int8 operands unpacked beforehand in "
          f"{unpack_s:.2f} s, not counted), equal to the route's (g, gq)")
    del got, lib
    rec = {"max_abs_err": err, "ms": time_ms(route, 10), "plain_ms": start.elapsed_time(end),
           "library_ms": lib_ms, **gram_bound(
        f"popcount_gram (mxu route) at {name}", n, None, W, 0, rb, 0, planes=4, products=15,
        popc=2, card=card, peak_ops=PEAK_B1)}
    print(f"# popcount_gram (mxu route) at {name}: kernel {rec['ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms (one run)")
    torch.cuda.empty_cache()
    return (pc_launches, coo_launches), rec


def phase_pack_cache(fasta: str, n: int, row_block: int, plain_csv: str, tmp: str, device):
    """The pack cache on the headline FASTA: a cold ``pack_fasta`` packs and
    stores, a warm one loads the planes (a read-only mmap) and they must equal;
    then one ``distance --pack-cache`` run served from the cache must write
    the bytes of phase 3's CSV.  Returns the cache's directory, which the
    mesh phase reads."""
    from tracs_tpu_torch.ops.packing import pack_cache_key, pack_fasta

    cache = os.path.join(tmp, "pack_cache")
    t0 = time.perf_counter()
    cold = pack_fasta(fasta, cache_dir=cache)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = pack_fasta(fasta, cache_dir=cache)
    t_warm = time.perf_counter() - t0
    entry = os.path.join(cache, pack_cache_key(fasta))
    size = sum(os.path.getsize(os.path.join(entry, f)) for f in os.listdir(entry))
    print(f"# pack cache: cold pack_fasta (pack + store) {t_cold:.3f} s, warm (load) "
          f"{t_warm:.3f} s; entry {size / 1e9:.2f} GB")
    if not isinstance(warm.planes, np.memmap) or warm.names != cold.names \
            or warm.length != cold.length or not np.array_equal(warm.planes, cold.planes):
        fail("the pack cache's warm load differs from the cold pack")
    del cold, warm
    out = os.path.join(tmp, "dists_pack_cache.csv")
    argv = ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block", str(row_block),
            "--pack-cache", cache]
    wall, _, _, sha = _run_cli(argv, n, row_block, "distance --pack-cache CLI (warm)", device)
    with open(plain_csv, "rb") as fh:
        want = hashlib.sha256(fh.read()).hexdigest()
    print(f"# distance --pack-cache: {wall:.3f} s wall, sha256 {sha}")
    if sha != want:
        fail(f"the --pack-cache run's CSV (sha256 {sha}) differs from phase 3's ({want})")
    os.remove(out)
    return cache


def write_dates(path: str, n: int, cluster_size: int, seed: int) -> None:
    """Seeded metadata CSV of the headline workload: each cluster gets a base
    date in 2019-2021, and each member is dated 0-180 days after it."""
    from datetime import date, timedelta

    rng = np.random.default_rng(seed + 2)
    n_clusters = -(-n // cluster_size)
    base = rng.integers(0, 3 * 365, size=n_clusters)
    offset = rng.integers(0, 181, size=n)
    with open(path, "w") as fh:
        fh.write("name,date\n")
        for i in range(n):
            day = date(2019, 1, 1) + timedelta(days=int(base[i // cluster_size] + offset[i]))
            fh.write(f"{i},{day.isoformat()}\n")


def phase_meta(packed, fasta: str, cluster_size: int, row_block: int, seed: int,
               tmp: str, plain_fields, device):
    """``distance --meta`` through the CLI on the card; returns (wall s,
    every kernel's launches in the run, the run's (N, delta) columns)."""
    from tracs_tpu_torch.models.transcluster import lprob_k_given_N, trans_dist

    n = packed.n_seqs
    dates = os.path.join(tmp, "dates.csv")
    write_dates(dates, n, cluster_size, seed)
    out = os.path.join(tmp, "dists_meta.csv")
    argv = ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block", str(row_block),
            "--meta", dates]
    wall, counts, fields, sha = _run_cli(argv, n, row_block, "distance --meta CLI", device)
    print(f"# --meta CSV: {len(fields)} rows, sha256 {sha}")
    if [f[:2] for f in fields] != [f[:2] for f in plain_fields]:
        fail("the --meta run's rows differ from the run without --meta")
    if [f[3] for f in fields] != [f[3] for f in plain_fields]:
        fail("the --meta run's SNP distances differ from the run without --meta")
    N = np.array([int(f[3]) for f in fields], dtype=np.int64)
    years = np.array([float(f[2]) for f in fields])
    p0 = np.array([float(f[4]) for f in fields])
    eK = np.array([float(f[5]) for f in fields])
    if not (np.all((p0 >= 0) & (p0 <= 1)) and np.all(np.isfinite(eK) & (eK >= 0))):
        fail("a p0 outside [0, 1] or an E(K) that is not finite and >= 0")
    if any(f[6] != "NA" for f in fields):
        fail("the filtered column is not NA on a --meta run")
    n_blocks = -(-n // row_block)
    if not 1 <= counts["trans_k_loop"] <= n_blocks:
        fail(f"--meta run: {counts['trans_k_loop']} trans_k_loop launches for {n_blocks} "
             "row blocks (one a lookup with novel lanes)")

    rng = np.random.default_rng(seed + 3)
    pick = rng.choice(len(fields), size=min(2000, len(fields)), replace=False)
    # the reference's table lgamma[i] = lgamma(i); entry 0 (a pole) is never read
    lgamma = [math.inf] + [math.lgamma(i) for i in range(1, int(N.max()) + 3)]
    lp_scalar = np.array([lprob_k_given_N(N[k], 0, years[k], LAMB, BETA, lgamma)[0]
                          for k in pick])
    err_scalar = float(np.max(np.abs(np.log(p0[pick]) - lp_scalar) / np.maximum(1, np.abs(lp_scalar))))
    lp_cpu, ek_cpu = trans_dist(N[pick], years[pick], LAMB, BETA, PRECISION, device="cpu")
    err_p0 = float(np.max(np.abs(p0[pick] - np.exp(lp_cpu)) / np.abs(np.exp(lp_cpu))))
    err_ek = float(np.max(np.abs(eK[pick] - ek_cpu) / np.maximum(np.abs(ek_cpu), 1e-300)))
    print(f"# --meta sampled rows ({len(pick)}): log p0 vs scalar lprob_k_given_N rel err "
          f"{err_scalar:.3e}; p0 vs CPU model {err_p0:.3e}, E(K) vs CPU model {err_ek:.3e}")
    if max(err_scalar, err_p0, err_ek) > 1e-9:
        fail("sampled --meta rows disagree with the scalar model or the CPU model at 1e-9")
    return wall, counts, N, years


def phase_trans_dist(N, years, device):
    """trans_dist alone on the card over the run's pairs (every (N, delta)
    lane new), the k loop's kernel at one lookup of a job's lanes, and the
    reference goldens on the card at 1e-6.  Returns the kernel's record."""
    import torch

    from tracs_tpu_torch.models import transcluster as tc

    lanes = np.unique(np.stack([N.astype(np.float64), years], axis=1), axis=0)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        tc.trans_dist(N, years, LAMB, BETA, PRECISION, device=device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"# trans_dist on the card: {len(N)} pairs, {len(lanes)} unique (N, delta) lanes, "
          f"{', '.join(f'{t:.4f}' for t in times)} s (median {float(np.median(times)):.4f} s)")
    rec = trans_k_loop_kernel(lanes, device)
    day = 86400 / 31556952
    p0, eK = tc.trans_dist([0, 2], [day, day], 29.903, 73.0, 0.01, device=device)
    want_p0 = [0.23794988406662973, 0.024467137572328577]
    want_ek = [2.6335200453700187, 7.315670110063259]
    err = max(np.max(np.abs(np.exp(p0) - want_p0)), np.max(np.abs(eK - want_ek)))
    print(f"# trans_dist reference goldens on the card: max |err| {err:.3e}")
    if not err < 1e-6:
        fail("trans_dist misses the reference goldens on the card")
    return rec


#: lanes of one lookup of the 4,096-sample job: its ~13,700 novel (N, delta)
#: lanes come in 4 lookups, one a row block of 1,024
LOOKUP_LANES = 3425


def trans_k_loop_kernel(lanes, device, seed: int = 0) -> dict:
    """The k loop's kernel (``csrc/trans_k_loop.cu``) against its plain
    version, the blocked engine, at one lookup of ``LOOKUP_LANES`` lanes
    drawn from ``lanes`` (unique (N, years) rows): the same exit k on every
    lane and E(K) at 1e-12, or ``fail``.  Times a call (CUDA events around
    the wrapper), the card's own time (``device_ms``) and the plain engine.
    The bound is the latency of the longest lane's chain of dependent steps:
    the card's time for that lane alone, one thread in one launch (a step's
    latency depends on the lane's values, so no other lane's stands in)."""
    from tracs_tpu_torch.models import transcluster as tc

    rng = np.random.default_rng(seed)
    pick = lanes[np.sort(rng.choice(len(lanes), size=min(LOOKUP_LANES, len(lanes)),
                                    replace=False))]
    pick = pick[np.lexsort((pick[:, 0], pick[:, 1]))]
    kw = dict(lamb=LAMB, beta=BETA, threshold_Ek=PRECISION)
    lane, log_I0, lg_N2, _ = tc._seed_lanes(pick[:, 0].copy(), pick[:, 1].copy(),
                                            lamb=LAMB, beta=BETA, device=device)

    def kernel():
        return tc.trans_k_loop(lane, log_I0, lg_N2, **kw)

    def plain():
        return tc._k_loop_blocked(lane, log_I0, lg_N2, **kw)

    eK, k = (t.cpu().numpy() for t in kernel())
    weK, wk = (t.cpu().numpy() for t in plain())
    same_k = bool(np.array_equal(k, wk))
    bitwise = bool(np.array_equal(eK, weK))
    rel = float(np.max(np.abs(eK - weK) / np.maximum(np.abs(weK), 1e-300)))
    print(f"# trans_k_loop at one lookup ({len(pick)} lanes): exit k equal {same_k}, "
          f"E(K) bit for bit {bitwise}, max rel err {rel:.3e}; exit k "
          f"{int(k.min())}-{int(k.max())}, median {float(np.median(k)):.0f}")
    if not same_k or not rel <= 1e-12:
        fail("trans_k_loop disagrees with the blocked engine on the card")
    call = time_ms(kernel, 20)
    card = device_ms(kernel, 20)
    plain_ms = time_ms(plain, 3)
    last = int(np.argmax(k))
    alone = tuple(t[last:last + 1] for t in (*lane, log_I0, lg_N2))
    bound = device_ms(lambda: tc.trans_k_loop(alone[:6], *alone[6:], **kw), 5)
    steps = int(k.max()) - 1
    rec = {"max_abs_err": float(np.max(np.abs(eK - weK))), "ms": call, "device_ms": card,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "latency",
           "step_us": bound / steps * 1e3, "steps": steps, "lanes": len(pick), "bitwise": bitwise,
           **build_facts("trans_k_loop")}
    print(f"# trans_k_loop: a call {call:.4f} ms; card {card:.4f} ms; plain engine "
          f"{plain_ms:.3f} ms; the longest lane alone ({steps} steps, "
          f"{bound / steps * 1e3:.4f} us a step) {bound:.4f} ms, the bound (latency): share "
          f"{100 * bound / card:.1f}% (card), {100 * bound / call:.1f}% (a call); bytes "
          f"{len(pick) * 80 / 3.35e9:.5f} ms at 3.35 TB/s")
    return rec


def host_filter(packed, i, j, d, chunk: int = 256) -> np.ndarray:
    """Filtered distances of pairs (i, j) by the host bitset path on the
    numpy planes: ``filter_recomb_batch(mismatch_words(...))``."""
    from tracs_tpu_torch.ops.pairsnp import mismatch_words
    from tracs_tpu_torch.ops.recomb import filter_recomb_batch

    out = np.empty(len(i), dtype=np.int64)
    for s in range(0, len(i), chunk):
        e = s + chunk
        out[s:e] = filter_recomb_batch(mismatch_words(packed, packed, i[s:e], j[s:e]),
                                       d[s:e], packed.length)
    return out


def phase_filter(packed, fasta: str, row_block: int, seed: int, tmp: str, plain_fields,
                 device):
    """``distance --filter`` through the CLI on the card; returns every
    kernel's launches in that run and the CSV's sha256.  Splits the time of
    ``filter_pairs`` by step, with timers wrapped around the functions it
    calls (nothing of the filter changes): the ``scipy.stats`` import, the
    keep-table builds (``_keep_tables_for``), the native window pass
    (``native_filter_windows``), the mismatch-position kernel (launch and
    plan, to the card's end) and the position table's copy to the host
    with its numpy unpacking (the rest of ``mismatch_positions_device``)."""
    import importlib

    import torch

    from tracs_tpu_torch.ops import pairsnp as port
    from tracs_tpu_torch.ops import recomb
    from tracs_tpu_torch.runtime import native

    spent = {k: 0.0 for k in ("filter_pairs", "scipy.stats import", "keep tables",
                              "native window pass", "kernel", "device step")}
    calls = {"keep tables": 0, "kernel": 0}

    def timer(key, fn, sync=False):
        def wrapped(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            calls[key] = calls.get(key, 0) + 1
            return out
        return wrapped

    real_sf = recomb._binom_sf

    def binom_sf(*args):
        if "scipy.stats" not in sys.modules:
            t0 = time.perf_counter()
            importlib.import_module("scipy.stats")
            spent["scipy.stats import"] += time.perf_counter() - t0
        return real_sf(*args)

    patches = [(port, "filter_pairs", timer("filter_pairs", port.filter_pairs, sync=True)),
               (port, "mismatch_positions_device",
                timer("device step", port.mismatch_positions_device)),
               (port, "mismatch_positions_kernel",
                timer("kernel", port.mismatch_positions_kernel, sync=True)),
               (recomb, "_keep_tables_for", timer("keep tables", recomb._keep_tables_for)),
               (native, "native_filter_windows",
                timer("native window pass", native.native_filter_windows)),
               (recomb, "_binom_sf", binom_sf)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    # what the import costs a process that has not paid it (the CLI's)
    fresh = subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); import scipy.stats; "
         "print(time.perf_counter() - t)"], capture_output=True, text=True, timeout=300)
    print(f"# --filter: scipy.stats imported before the run: {'scipy.stats' in sys.modules}; "
          f"its import in a fresh process {fresh.stdout.strip() or fresh.stderr[-200:]} s")
    out = os.path.join(tmp, "dists_filter.csv")
    argv = ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block", str(row_block),
            "--filter"]
    for mod, name, fn in patches:  # only to read where the filter's time goes
        setattr(mod, name, fn)
    try:
        wall, counts, fields, sha = _run_cli(argv, packed.n_seqs, row_block,
                                             "distance --filter CLI", device)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    total = spent["filter_pairs"]
    split = {"scipy.stats import": spent["scipy.stats import"],
             f"keep tables ({calls['keep tables']} batches)": spent["keep tables"],
             "native window pass": spent["native window pass"],
             f"mismatch-position kernel ({calls['kernel']} calls, plan to the card's end)":
                 spent["kernel"],
             "position table to the host": spent["device step"] - spent["kernel"]}
    split["the rest (numpy in filter_pairs and _filter_flat)"] = total - sum(split.values())
    print(f"# --filter: filter_pairs {total:.3f} s: " + "; ".join(
        f"{k} {v:.3f} s ({100 * v / total:.1f}%)" for k, v in split.items()))
    print(f"# --filter CSV: {len(fields)} rows, sha256 {sha}; filter_pairs {total:.3f} s, "
          f"{100 * total / wall:.2f}% of the wall")
    if counts["mism_positions"] < 1 or counts["mism_positions (tiled)"] != counts["mism_positions"]:
        fail(f"the --filter run launched the mismatch-position kernels "
             f"{counts['mism_positions']} times, the tiled one {counts['mism_positions (tiled)']}: "
             f"the main path should take the tiled kernel every time")
    same = (0, 1, 2, 3, 4, 5, 7, 8)
    if [[f[k] for k in same] for f in fields] != [[f[k] for k in same] for f in plain_fields]:
        fail("the --filter run's rows differ from the run without --filter outside the "
             "filtered column")
    i = np.array([int(f[0]) for f in fields], dtype=np.int64)
    j = np.array([int(f[1]) for f in fields], dtype=np.int64)
    d = np.array([int(f[3]) for f in fields], dtype=np.int64)
    filt = np.array([int(f[6]) for f in fields], dtype=np.int64)
    if not np.all((0 <= filt) & (filt <= d)):
        fail("a filtered distance outside [0, SNP distance]")
    rng = np.random.default_rng(seed + 5)
    pick = rng.choice(len(fields), size=min(2000, len(fields)), replace=False)
    want = host_filter(packed, i[pick], j[pick], d[pick])
    if not np.array_equal(filt[pick], want):
        fail("sampled --filter rows disagree with the host bitset path")
    print(f"# --filter: {len(pick)} sampled rows equal the host bitset path; "
          f"{int((filt < d).sum())} of {len(fields)} rows lost SNPs to the filter")
    return counts, sha


def planted_alignment(n: int, L: int, seed: int):
    """(PackedAlignment, has_tract [n] bool): n samples off one random base
    genome, each with 20-60 scattered substitutions, every fourth with a
    tract of 30 more within 2 kb."""
    from tracs_tpu_torch.ops.packing import PackedAlignment, nibbles_to_planes

    rng = np.random.default_rng(seed + 4)
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)
    base = rng.integers(0, 4, size=L)
    nib = np.repeat(codes[base][None, :], n, axis=0)
    has_tract = np.arange(n) % 4 == 0
    for k in range(n):
        pos = rng.choice(L, size=int(rng.integers(20, 61)), replace=False)
        if has_tract[k]:
            start = int(rng.integers(0, L - 2000))
            pos = np.union1d(pos, start + rng.choice(2000, size=30, replace=False))
        nib[k, pos] = codes[(base[pos] + rng.integers(1, 4, size=len(pos))) % 4]
    packed = PackedAlignment(planes=nibbles_to_planes(nib), length=L,
                             names=[f"p{k}" for k in range(n)])
    return packed, has_tract


def phase_planted(L: int, seed: int, device):
    """The planted recombination case through ``pairsnp_stream(filter=True)``
    with compaction on."""
    import torch

    from tracs_tpu_torch.ops.pairsnp import INT32_MAX, _cached_compact, pairsnp_stream

    n = PLANTED_N
    packed, has_tract = planted_alignment(n, L, seed)
    reset_counts()
    t0 = time.perf_counter()
    blocks = list(pairsnp_stream([packed], dist=INT32_MAX, filter=True, row_block=n // 2,
                                 device=device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    comp = _cached_compact(packed, packed)
    if comp is None or comp[0].planes.shape[2] >= packed.planes.shape[2]:
        fail("planted case: the compaction dropped no column, so no position map was in use")
    rows, cols, d, filt = (np.concatenate([b[k] for b in blocks]) for k in (3, 4, 5, 6))
    print(f"# planted: n={n} L={L}, {len(rows)} pairs in {wall:.3f} s, compacted "
          f"{packed.planes.shape[2]} -> {comp[0].planes.shape[2]} words, split_gram launches "
          f"{counts['split_gram']}, coo_extract launches {counts['coo_extract']}, "
          f"mism_positions launches {counts['mism_positions']} (the tiled kernel "
          f"{counts['mism_positions (tiled)']}, the warp kernel "
          f"{counts['mism_positions'] - counts['mism_positions (tiled)']}: whole rows of pairs "
          f"with no threshold stage more samples than pairs, so the rule takes the warp kernel)")
    if len(rows) != n * (n - 1) // 2 or counts["mism_positions"] < 1 \
            or counts["coo_extract"] != len(blocks):
        fail("planted case: pairs missing, or the mismatch-position kernel not launched, or "
             "not one coo_extract launch a block")
    tract = has_tract[rows] | has_tract[cols]
    if not np.all(filt[tract] < d[tract]) or not np.all(filt <= d):
        fail("planted case: a pair with a tract kept every SNP, or a filtered distance above d")
    t0 = time.perf_counter()
    want = host_filter(packed, rows, cols, d)
    if not np.array_equal(filt, want):
        fail("planted case: pairsnp_stream(filter=True) disagrees with the host bitset path")
    lost = d - filt
    print(f"# planted: every pair equals the host bitset path ({time.perf_counter() - t0:.1f} s "
          f"on the host); {int(tract.sum())} pairs with a tract lost {int(lost[tract].min())}.."
          f"{int(lost[tract].max())} SNPs, the others {int(lost[~tract].min())}.."
          f"{int(lost[~tract].max())}")


def phase_experiments(n: int, L: int, device, card, recs):
    """The variant sweep through its entry point, then K1 and every variant
    against its plain version at that path's own shape: the full n x n square
    on the entry point's layout, exact.  The launch counts are read before
    those comparisons.  Returns the launch counts of the entry point's run;
    the variants' records in ``recs`` move to the full square (``ms``
    the entry point's median, ``plain_ms`` one run of the plain version, the
    bound of the square), their main-path-block times kept as ``block_ms``
    and ``block_plain_ms``."""
    from functools import partial

    import torch

    from tracs_tpu_torch.experiments import kernel_experiments
    from tracs_tpu_torch.experiments.workload import make_clustered
    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.pairsnp import _cached_split, _split_device

    reset_counts()
    t0 = time.perf_counter()
    rows = kernel_experiments.main([str(n), str(L), "--device", "cuda"])
    counts = read_counts()
    print(f"# experiments entry point: {time.perf_counter() - t0:.1f} s in all")
    for variant in kernels.SPLIT_GRAM_VARIANTS:
        name = kernels.variant_name(*variant)
        if counts[name] < 1:
            fail(f"the experiments entry point never launched variant {name}")
    if any(r["ok"] is False for r in rows) or len(rows) != 1 + len(kernels.SPLIT_GRAM_VARIANTS):
        fail("the experiments entry point reported a mismatch or skipped a variant")
    rows = {r["name"]: r for r in rows}

    # the entry point's layout again (it keeps none), as kernel_experiments.run builds it
    ea, nm, _ = _split_device(_cached_split(make_clustered(n, L), device), device)
    W = (L + 31) // 32   # the work; the layout's pitch, ea.shape[2], pads it to a multiple of 4
    shape = f"full square rb={n} n={n} W={W}"
    want, plain_ms = {}, {}
    for dot in ("b1", "s8", "bf16"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want[dot] = kernels.split_gram_variant_reference(ea, nm, 0, n, 0, dot=dot)
        end.record()
        torch.cuda.synchronize()
        plain_ms[dot] = start.elapsed_time(end)
    fns = {"split_gram": (kernels.split_gram, "b1")}
    for dot, tile, unpack in kernels.SPLIT_GRAM_VARIANTS:
        fns[kernels.variant_name(dot, tile, unpack)] = (
            partial(kernels.split_gram_variant, dot=dot, tile=tile, unpack=unpack), dot)
    for kname, (fn, dot) in fns.items():
        got = fn(ea, nm, 0, n, 0)
        torch.cuda.synchronize()
        err = [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want[dot])]
        print(f"# {kname} vs plain, {shape}: out {tuple(got[0].shape)}, max |err| {err}; "
              f"kernel {rows[kname]['ms']:.3f} ms (the entry point's median), plain ({dot}) "
              f"{plain_ms[dot]:.3f} ms (one run)")
        if any(err):
            fail(f"{kname} disagrees with its plain version at {shape}")
        del got
        recs[kname]["max_abs_err"] = [max(e, f) for e, f in zip(recs[kname]["max_abs_err"], err)]
        if kname == "split_gram":
            continue  # K1's main path is the distance run: its record stays at the block
        rec = recs[kname]
        rec.update(block_ms=rec["ms"], block_plain_ms=rec["plain_ms"], ms=rows[kname]["ms"],
                   plain_ms=plain_ms[dot], **gram_bound(
                       f"{kname} at {shape}", n, None, W, 0, n, 0, planes=5, products=5,
                       popc=5, card=card,
                       peak_ops=PEAK_BY_DOT[dot]))
    # every variant computes K1's function: one library time at the square
    want = want["b1"]
    lib_ms, unpack_s, lib = library_split_gram(ea, nm, 0, n, 0)
    if not all(torch.equal(x, y) for x, y in zip(lib, want)):
        fail(f"torch._int_mm's G4 - Gn and Gn differ from the plain version at {shape}")
    print(f"# K1's function at {shape}: torch._int_mm G4 + Gn {lib_ms:.3f} ms (int8 operands "
          f"unpacked beforehand in {unpack_s:.2f} s, not counted), equal to the plain version")
    for variant in kernels.SPLIT_GRAM_VARIANTS:
        recs[kernels.variant_name(*variant)]["library_ms"] = lib_ms
    del lib, want, ea, nm
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: reads to clusters
# ---------------------------------------------------------------------------

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def pipe_samples(L: int, n: int, n_clusters: int, seed: int):
    """(reference codes [L] in 0..3, samples): ``n`` samples in ``n_clusters``
    planted clusters off one random reference.  A cluster's centre is the
    reference with 300 substitutions, a member its centre with 1 to 3 more.
    Each sample is a dict: ``seq`` codes [L]; ``fwd``/``rev`` reads a strand
    of its allele at every site (8-12 each, 1 on the thin stretches);
    ``absent`` sites without a pileup line; ``special`` positions that show
    a ``second`` allele with ``second_reads`` [m, 2] (fwd, rev) of the site's
    reads: mixed sites or sequencing noise; ``expected`` the nibbles the align stage
    must call (N on thin and absent stretches, two bits at mixed sites)."""
    rng = np.random.default_rng(seed + 6)
    ref = rng.integers(0, 4, size=L, dtype=np.uint8)

    def substitute(seq, k):
        pos = rng.choice(L, size=k, replace=False)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=k, dtype=np.uint8)) % 4

    centres = []
    for _ in range(n_clusters):
        c = ref.copy()
        substitute(c, 300)
        centres.append(c)
    samples = []
    for k in range(n):
        seq = centres[k % n_clusters].copy()
        substitute(seq, int(rng.integers(1, 4)))
        fwd = rng.integers(8, 13, size=L, dtype=np.uint8)
        rev = rng.integers(8, 13, size=L, dtype=np.uint8)
        low = np.zeros(L, dtype=bool)
        absent = np.zeros(L, dtype=bool)
        for stretch in range(4):  # two stretches without a line, two of one read a strand
            start = int(rng.integers(0, L - 3000))
            span = slice(start, start + int(rng.integers(500, 3000)))
            low[span] = True
            if stretch < 2:
                absent[span] = True
        fwd[low] = rev[low] = 1
        # 300 mixed sites (two alleles on both strands, the second 4-5 of a
        # strand's 8-12 reads) and as many noisy ones (an error allele with one
        # read a strand: above the error threshold, so in the fit, and below
        # the posterior threshold, so out of the call).  Minor fractions from
        # 8% to 60% make the fitted concentration small, as real pileups do.
        special = np.sort(rng.choice(np.nonzero(~low)[0], size=600, replace=False))
        is_mixed = rng.permutation(600) < 300
        second = (seq[special] + rng.integers(1, 4, size=600, dtype=np.uint8)) % 4
        second_reads = np.where(is_mixed[:, None], rng.integers(4, 6, size=(600, 2)),
                                np.ones((600, 2), dtype=np.int64))  # fwd, rev
        expected = (np.uint8(1) << seq).astype(np.uint8)
        expected[special[is_mixed]] |= np.uint8(1) << second[is_mixed]
        expected[low] = 15
        samples.append(dict(name=f"s{k:02d}", cluster=k % n_clusters, seq=seq, fwd=fwd, rev=rev,
                            absent=absent, special=special, second=second,
                            second_reads=second_reads, expected=expected))
    return ref, samples


def pileup_bytes(ref: np.ndarray, sample: dict, contig: bytes = b"chr1") -> bytes:
    """The sample's htsbox-format pileup text, one line a covered site:
    ``contig pos ref . nucs x:fwd:rev`` (several alleles: ``A,G`` and
    ``x:f1,f2:r1,r2``), built as a byte matrix of one row a site whose unused
    cells are 0 and dropped at the end: a Python loop over 2 M lines a sample
    would take longer than everything it stands in front of."""
    L = len(ref)
    width = len(contig) + 36
    rows = np.zeros((L, width), dtype=np.uint8)
    col = len(contig)
    rows[:, :col] = np.frombuffer(contig, dtype=np.uint8)
    rows[:, col] = 9
    pos = np.arange(1, L + 1, dtype=np.int64)
    for k in range(7):  # 7 digits, leading zeros dropped
        digit = (pos // 10 ** (6 - k)) % 10 + 48
        rows[:, col + 1 + k] = np.where(pos >= 10 ** (6 - k), digit, 0)
    col += 8
    rows[:, col] = 9
    rows[:, col + 1] = _BASES[ref]
    rows[:, col + 2:col + 5] = np.frombuffer(b"\t.\t", dtype=np.uint8)
    rows[:, col + 5] = _BASES[sample["seq"]]
    rows[:, col + 6:col + 9] = np.frombuffer(b"\t2:", dtype=np.uint8)
    col += 9
    for at, reads in ((col, sample["fwd"]), (col + 3, sample["rev"])):
        rows[:, at] = np.where(reads >= 10, reads // 10 + 48, 0)
        rows[:, at + 1] = reads % 10 + 48
    rows[:, col + 2] = ord(":")
    rows[:, col + 5] = 10
    for p, b2, (bf, br) in zip(sample["special"], sample["second"], sample["second_reads"]):
        af, ar = sample["fwd"][p] - bf, sample["rev"][p] - br  # the strand's depth is shared
        line = b"%s\t%d\t%c\t.\t%c,%c\t2:%d,%d:%d,%d\n" % (
            contig, p + 1, _BASES[ref[p]], _BASES[sample["seq"][p]], _BASES[b2], af, bf, ar, br)
        rows[p] = 0
        rows[p, :len(line)] = np.frombuffer(line, dtype=np.uint8)
    rows[sample["absent"]] = 0
    return rows[rows != 0].tobytes()


def phase_pipe(seed: int, tmp: str, device, card):
    """Reads to clusters through ``cli.main(["pipe", ...])`` on the card, at
    PIPE_SITES x PIPE_SAMPLES; returns (every kernel's launches in the run,
    the split-gram kernel's record at the run's shape for the JSON line)."""
    import gzip
    import zipfile

    import torch

    from tracs_tpu_torch import cli
    from tracs_tpu_torch.io.external import require_tool
    from tracs_tpu_torch.io.fasta import read_fasta
    from tracs_tpu_torch.models import dirichlet
    from tracs_tpu_torch.ops.packing import IUPAC_BY_NIBBLE
    from tracs_tpu_torch.stages import align as align_mod
    from tracs_tpu_torch.stages import pipe as pipe_mod

    found = []
    for tool in ("minimap2", "samtools", "htsbox", "sourmash"):
        try:
            require_tool(tool)
            found.append(f"{tool} yes")
        except RuntimeError:
            found.append(f"{tool} no")
    print(f"# aligner binaries on PATH: {', '.join(found)}")

    L, n = PIPE_SITES, PIPE_SAMPLES
    t0 = time.perf_counter()
    ref, samples = pipe_samples(L, n, PIPE_CLUSTERS, seed)
    by_name = {s["name"]: s for s in samples}
    work = os.path.join(tmp, "pipe")
    os.makedirs(work)
    rng = np.random.default_rng(seed + 7)
    genomes = {"REFA": ref, "DECOY": rng.integers(0, 4, size=L, dtype=np.uint8)}
    inputs = []
    for name, codes in genomes.items():
        fasta = os.path.join(work, name + ".fasta")
        with open(fasta, "wb") as fh:
            fh.write(b">chr1\n" + _BASES[codes].tobytes() + b"\n")
        inputs.append(fasta)
    # the database through the build-db stage: no sourmash on the card's
    # machine, so the genomes and the port's native sketches, no SBT member
    t_db = time.perf_counter()
    cli.main(["build-db", "-i", *inputs, "-o", os.path.join(work, "db")])
    t_db = time.perf_counter() - t_db
    db = os.path.join(work, "db.zip")
    with zipfile.ZipFile(db) as z:
        members = sorted(z.namelist())
    print(f"# build-db: {t_db:.3f} s, members {members}")
    if members != ["DECOY.fasta.gz", "REFA.fasta.gz", "native_sketches.npz", "summary.tsv"]:
        fail(f"build-db wrote the members {members}")
    tsv = os.path.join(work, "input.tsv")
    with open(tsv, "w") as fh:
        fh.write("prefix\tr1\n")
        for s in samples:
            reads = os.path.join(work, s["name"] + ".fastq.gz")
            with gzip.open(reads, "wb", compresslevel=1) as rf:
                rf.write(b"@" + s["name"].encode() + b"\n" + _BASES[s["seq"]].tobytes()
                         + b"\n+\n" + b"F" * L + b"\n")
            fh.write(f"{s['name']}\t{reads}\n")
    print(f"# pipe inputs: {n} samples x {L} sites in {PIPE_CLUSTERS} planted clusters, database "
          f"of {len(genomes)} genomes with native sketches, made in "
          f"{time.perf_counter() - t0:.1f} s")

    spent = {}
    iterations = []
    model_peak = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    def stand_in(reference, outdir, prefix, r1, r2=None, **kw):
        """In place of minimap2 | samtools | htsbox: the sample's pileup."""
        sample = by_name[os.path.basename(prefix).split("_ref_")[0]]
        with gzip.open(prefix + "_pileup.txt.gz", "wb", compresslevel=1) as fh:
            fh.write(pileup_bytes(ref, sample))

    def fit_loop(*args):
        """The fit's fixed-point loop, keeping the iteration count."""
        alpha, its = saved_fit_loop(*args)
        iterations.append(its)
        return alpha, its

    def on_card(name, fn):
        """A model function as ``align`` calls it: fails unless it is handed
        its counts on the card; keeps the call's peak allocation above what
        was resident before the run."""
        def run(counts, *args, **kwargs):
            if not (isinstance(counts, torch.Tensor) and counts.device.type == "cuda"):
                fail(f"pipe: {name} was handed counts that are not on the card")
            torch.cuda.reset_peak_memory_stats()
            out = fn(counts, *args, **kwargs)
            model_peak[name] = max(model_peak.get(name, 0),
                                   torch.cuda.max_memory_allocated() - held)
            return out
        return run

    patches = [(align_mod, "align_and_pileup", timed("stand-in pileup writing", stand_in)),
               (align_mod, "native_gather", timed("native gather", align_mod.native_gather)),
               (align_mod, "parse_pileup", timed("parse_pileup", align_mod.parse_pileup)),
               (dirichlet, "_fit", fit_loop),
               (align_mod, "find_dirichlet_priors",
                timed("find_dirichlet_priors",
                      on_card("find_dirichlet_priors", align_mod.find_dirichlet_priors))),
               (align_mod, "posteriors_on_device",
                timed("calculate_posteriors",
                      on_card("calculate_posteriors", align_mod.posteriors_on_device))),
               (align_mod, "distinct_values",
                timed("distinct values and the copy back", align_mod.distinct_values)),
               (align_mod, "write_posterior_csv",
                timed("posterior CSV writing", align_mod.write_posterior_csv)),
               (align_mod, "nibble_sequence",
                timed("IUPAC string", align_mod.nibble_sequence)),
               (pipe_mod, "align", timed("align", pipe_mod.align)),
               (pipe_mod, "distance", timed("distance", pipe_mod.distance)),
               (pipe_mod, "cluster", timed("cluster", pipe_mod.cluster))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    saved_fit_loop = dirichlet._fit
    out = os.path.join(work, "out")
    reset_counts()
    torch.cuda.synchronize()
    gc.collect()  # what earlier phases dropped must not be freed in the middle of this one
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # what earlier phases left resident
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        t0 = time.perf_counter()
        cli.main(["pipe", "-i", tsv, "--database", db, "-o", out, "-D", "100"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    counts = read_counts()
    inside = sum(v for k, v in spent.items() if k not in ("align", "distance", "cluster"))
    print(f"# pipe CLI: {wall:.3f} s wall for {n} samples; align {spent['align']:.3f} s, "
          f"distance {spent['distance']:.3f} s, cluster {spent['cluster']:.3f} s")
    print("# pipe, inside align (sums over the samples): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in spent.items() if k not in ("align", "distance", "cluster"))
        + f", the rest (reference extraction, host statistics, FASTA) "
          f"{spent['align'] - inside:.3f} s")
    print(f"# pipe: find_dirichlet_priors took {min(iterations)}..{max(iterations)} iterations a "
          f"sample; split_gram launches {counts['split_gram']}, partial_gram "
          f"{counts['partial_gram']}, coo_extract {counts['coo_extract']}; peak device allocation above "
          f"what was resident before, inside " + ", ".join(
              f"{k} {v / 1e6:.1f} MB" for k, v in model_peak.items())
          + f" (a count matrix is {L * 4 * 8 / 1e6:.1f} MB)")
    # the called FASTAs hold two-allele IUPAC codes: every block needs the correction gram
    if counts["split_gram"] < 1 or not \
            counts["partial_gram"] == counts["coo_extract"] == counts["split_gram"]:
        fail(f"pipe: the distance step launched split_gram {counts['split_gram']}, partial_gram "
             f"{counts['partial_gram']} and coo_extract {counts['coo_extract']} times; one each "
             f"a block expected")
    if len(iterations) != n or len(model_peak) != 2 \
            or min(model_peak.values()) <= L * 4 * 8:
        fail("pipe: a model function did not hold a count matrix on the card")

    # every called FASTA against the planted genome
    for s in samples:
        path = os.path.join(out, s["name"], f"{s['name']}_posterior_counts_ref_REFA.fasta")
        if not os.path.exists(path):
            fail(f"pipe: no called FASTA for {s['name']}")
        (name, called), = read_fasta(path)
        want = IUPAC_BY_NIBBLE[s["expected"]].tobytes().decode()
        if name != f"{s['name']}_REFA" or called != want:
            got = np.frombuffer(called.encode(), dtype=np.uint8)
            bad = (np.nonzero(got != np.frombuffer(want.encode(), dtype=np.uint8))[0]
                   if len(got) == L else [])
            fail(f"pipe: the called FASTA of {s['name']} differs from the planted genome at "
                 f"{len(bad)} sites (first {list(bad[:5])}), length {len(called)}")
        if os.path.exists(os.path.join(out, s["name"],
                                       f"{s['name']}_posterior_counts_ref_DECOY.fasta")):
            fail(f"pipe: the gather selected the decoy genome for {s['name']}")
    n_codes = sum(int(np.isin(s["expected"], (3, 5, 6, 9, 10, 12)).sum()) for s in samples)
    n_low = sum(int((s["expected"] == 15).sum()) for s in samples)
    print(f"# pipe: {n} called FASTAs equal the planted genomes ({n_low} N sites on low-coverage "
          f"stretches, {n_codes} two-allele IUPAC codes)")

    # the planted distances: two samples mismatch where their allele sets are disjoint
    want_rows = {}
    planted_pairs = {}
    for i in range(n):
        for j in range(i + 1, n):
            a, b = samples[i]["expected"], samples[j]["expected"]
            d = int(np.count_nonzero((a & b) == 0))
            nn = L - int(np.count_nonzero((a == 15) | (b == 15)))
            planted_pairs[frozenset((samples[i]["name"], samples[j]["name"]))] = (d, nn)
            if d <= 100:
                want_rows[frozenset((samples[i]["name"], samples[j]["name"]))] = (d, nn)
            if (d <= 100) != (samples[i]["cluster"] == samples[j]["cluster"]):
                fail("pipe: the planted clusters are not what the planted distances separate")
    with open(os.path.join(out, "transmission_distances.csv")) as fh:
        rows = [ln.strip().split(",") for ln in fh.readlines()[1:]]
    got_rows = {frozenset((r[0][:-5], r[1][:-5])): (int(r[3]), int(r[7])) for r in rows}
    if len(rows) != len(got_rows) or got_rows != want_rows:
        fail(f"pipe: transmission_distances.csv holds {len(rows)} rows, the planted "
             f"within-threshold pairs are {len(want_rows)}, or a distance differs")
    if any(r[2] != "NA" or r[6] != "0" or r[8] != "combinedREFA" for r in rows):
        fail("pipe: a distance row's date, filtered or MSA column is not what pipe writes")
    dists = sorted(d for d, _ in want_rows.values())
    print(f"# pipe: transmission_distances.csv holds exactly the {len(rows)} planted pairs, SNP "
          f"distances {dists[0]}..{dists[-1]}, sites considered exact")
    with open(os.path.join(out, "transmission_clusters.csv")) as fh:
        labels = dict(ln.strip().split(",") for ln in fh.readlines()[1:])
    groups = {}
    for name, label in labels.items():
        groups.setdefault(label, set()).add(name[:-5])
    planted = {}
    for s in samples:
        planted.setdefault(s["cluster"], set()).add(s["name"])
    if sorted(map(sorted, groups.values())) != sorted(map(sorted, planted.values())):
        fail("pipe: transmission_clusters.csv does not group exactly the planted clusters")
    print(f"# pipe: transmission_clusters.csv groups the {len(planted)} planted clusters of "
          f"{n // len(planted)}")

    # K1 at the shape this path gave it: the run's combined alignment, packed
    # and laid out as the distance stage does, against the plain version; then
    # every pair of the sweep, unbounded, against the planted distances
    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.packing import pack_fasta
    from tracs_tpu_torch.ops.pairsnp import _cached_compact, _split_device, _split_pair, pairsnp

    packed = pack_fasta(os.path.join(out, "combinedREFA"))
    comp = _cached_compact(packed, packed)
    a_k = packed if comp is None else comp[0]
    ea, nm, _ = _split_device(_split_pair(a_k, None, device)[0], device)
    W = ea.shape[2]
    shape = f"the pipe run's shape, n={n} W={W} (of {-(-L // 32)} words before compaction)"
    args = (ea, nm, 0, n, 0)
    got = kernels.split_gram(*args)
    torch.cuda.synchronize()
    want = kernels.split_gram_reference(*args)
    err = [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)]
    print(f"# split_gram vs plain, {shape}: out {tuple(got[0].shape)}, max |err| {err}")
    if packed.n_seqs != n or any(err):
        fail(f"split_gram disagrees with its plain version at {shape}")
    rec = {"max_abs_err": err, "ms": time_ms(lambda: kernels.split_gram(*args), 10),
           "plain_ms": time_ms(lambda: kernels.split_gram_reference(*args), 3),
           **gram_bound(f"split_gram at {shape}", n, None, W, 0, n, 0, planes=5, products=5,
                        popc=5, card=card, peak_ops=PEAK_B1)}
    lib_ms, _, lib = library_split_gram(*args)
    if not all(torch.equal(x, y) for x, y in zip(got, lib)):
        fail(f"torch._int_mm's G4 - Gn and Gn differ from split_gram's at {shape}")
    rec["library_ms"] = lib_ms
    print(f"# split_gram at {shape}: kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms "
          f"(median); torch._int_mm G4 + Gn {lib_ms:.4f} ms (rows zero-padded to 17, since "
          f"_int_mm takes more than 16), equal to the kernel's")
    del lib
    pi, pj, pd, names, _, pnn = pairsnp([packed], device=device)
    swept = {frozenset((names[i][:-5], names[j][:-5])): (int(d), int(nn))
             for i, j, d, nn in zip(pi, pj, pd, pnn)}
    if len(pi) != n * (n - 1) // 2 or swept != planted_pairs:
        wrong = [sorted(k) for k in planted_pairs if swept.get(k) != planted_pairs[k]]
        fail(f"pipe: the sweep over the run's alignment differs from the planted distance or "
             f"sites considered at {len(wrong)} of {len(planted_pairs)} pairs (first {wrong[:3]})")
    far = sorted(d for d, _ in planted_pairs.values() if d > 100)
    print(f"# pipe: all {len(swept)} pairs of the sweep equal the planted SNP distance and sites "
          f"considered ({len(far)} cross-cluster pairs, {far[0]}..{far[-1]} apart)")

    # threshold: the close pairs are pipe's distance CSV (the within-cluster
    # pairs), the distant ones the sweep's cross-cluster pairs in its schema
    distant = os.path.join(work, "distant.csv")
    with open(os.path.join(out, "transmission_distances.csv")) as src, open(distant, "w") as fh:
        fh.write(src.readline())
        for i, j, d, nn in zip(pi, pj, pd, pnn):
            if d > 100:
                fh.write(f"{names[i]},{names[j]},NA,{d},NA,NA,0,{nn},combinedREFA\n")
    t0 = time.perf_counter()
    cli.main(["threshold", "--close", os.path.join(out, "transmission_distances.csv"),
              "--distant", distant, "-o", os.path.join(work, "threshold.csv"), "--column", "3"])
    t_thr = time.perf_counter() - t0
    with open(os.path.join(work, "threshold.csv")) as fh:
        fit = dict(line.strip().split(",") for line in fh.readlines()[1:])
    cutoff = float(fit["snp_threshold"])
    print(f"# threshold: {t_thr:.3f} s; r {float(fit['r']):.4g}, p {float(fit['p']):.4g}, "
          f"q {float(fit['q']):.4g}, lambda {float(fit['lambda']):.4g}; cutoff {cutoff} between "
          f"the close pairs (<= {dists[-1]}) and the distant ones (>= {far[0]})")
    if not dists[-1] < cutoff < far[0]:
        fail(f"threshold: the fitted cutoff {cutoff} does not separate the planted close pairs "
             f"(up to {dists[-1]}) from the distant ones (from {far[0]})")
    del got, want, ea, nm, args, packed

    # the two model functions on the CPU at the same size, for one sample
    s = samples[0]
    pileup = os.path.join(out, s["name"], f"{s['name']}_ref_REFA_pileup.txt.gz")
    counts_np = align_mod.parse_pileup(pileup, {"chr1": L})
    times = {}
    results = {}
    for dev in ("cpu", device):
        key = "cpu" if dev == "cpu" else "card"
        counts_dev = torch.from_numpy(counts_np).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        del iterations[:]
        dirichlet._fit = fit_loop
        try:
            alphas = dirichlet.find_dirichlet_priors(counts_dev, method="FPI",
                                                     error_filt_threshold=0.01, device=dev)
        finally:
            dirichlet._fit = saved_fit_loop
        its = sum(iterations)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        post = dirichlet.calculate_posteriors(counts_dev, alphas, False, 0.25, device=dev)
        torch.cuda.synchronize()
        times[key] = (t1 - t0, time.perf_counter() - t1, its)
        results[key] = (alphas, post)
    print(f"# model on one sample ({L} x 4 counts): find_dirichlet_priors card "
          f"{times['card'][0]:.3f} s ({times['card'][2]} iterations), CPU {times['cpu'][0]:.3f} s "
          f"({times['cpu'][2]} iterations); calculate_posteriors card {times['card'][1]:.3f} s, "
          f"CPU {times['cpu'][1]:.3f} s")
    err_a = float(np.max(np.abs(results["card"][0] - results["cpu"][0])
                         / np.maximum(results["cpu"][0], 1e-300)))
    pc, pg = results["cpu"][1], results["card"][1]
    err_p = float(np.max(np.abs(pg - pc) / np.maximum(pc, 1e-300)))
    print(f"# model, card vs CPU: alphas rel err {err_a:.3e}, posteriors rel err {err_p:.3e}, "
          f"zero patterns equal: {bool(np.array_equal(pg == 0, pc == 0))}")
    if times["card"][2] != times["cpu"][2] or max(err_a, err_p) > 1e-9 \
            or not np.array_equal(pg == 0, pc == 0):
        fail("pipe: the model on the card disagrees with the model on the CPU at 1e-9")
    return counts, rec


# ---------------------------------------------------------------------------
# phase 11: the dp x sp mesh (parallel/), at the headline size
# ---------------------------------------------------------------------------

#: seconds a spawned world of ranks may take before the phase fails
MESH_WORLD_TIMEOUT = 300


def _stream_arrays(blocks):
    """(spans, rows, cols, d, filt, nn) of a pairsnp_stream run."""
    spans = [tuple(b[:2]) for b in blocks]
    cat = [np.concatenate([b[k] for b in blocks]) if blocks else np.zeros(0, np.int64)
           for k in (3, 4, 5, 6, 7)]
    return spans, cat


def _spy_engines():
    """Records the mesh engine each pairsnp_stream call builds; returns the
    list and a function that undoes the wrapping."""
    from tracs_tpu_torch.parallel import allpairs

    made, real = [], {c: c.__init__ for c in (allpairs.RingCoo, allpairs.ShardedSweep)}
    for cls in real:
        def init(self, *a, _cls=cls, **k):
            made.append(_cls.__name__)
            real[_cls](self, *a, **k)
        cls.__init__ = init

    def undo():
        for cls, fn in real.items():
            cls.__init__ = fn
    return made, undo


def _mesh_rank(rank: int, n: int, url: str, jobs: list, outdir: str, repo: str) -> None:
    """One gloo rank on cuda:0 (spawned by ``phase_mesh``): ``initialize``
    with ``backend="gloo"``, then each job in turn, every rank together.  A
    job's launch counts, collective bytes, wall and peak allocation go to
    ``outdir/<tag>.<rank>.json``."""
    import datetime

    sys.path.insert(0, repo)
    import torch
    import torch.distributed as dist

    from tracs_tpu_torch import cli
    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.packing import pack_fasta
    from tracs_tpu_torch.ops.pairsnp import _cached_compact, _split_pair, pairsnp_stream
    from tracs_tpu_torch.parallel import allpairs, mesh as mesh_mod, multihost

    torch.set_num_threads(2)
    if not multihost.initialize(url, n, rank, device="cuda", backend="gloo",
                                timeout=datetime.timedelta(seconds=MESH_WORLD_TIMEOUT)):
        raise RuntimeError("no process group was set up")
    device = torch.device("cuda", torch.cuda.current_device())
    for job in jobs:
        reset_counts()
        mesh_mod.COLLECTIVE_BYTES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        extra = {}
        if job["kind"] == "cli":
            cli.main(job["argv"])
        else:  # the block sweep through the API from row start_row (the --resume route)
            packed = pack_fasta(job["fasta"], cache_dir=job["cache"])
            made, undo = _spy_engines()
            mesh = mesh_mod.make_mesh(*job["shape"])
            blocks = list(pairsnp_stream([packed], dist=200, row_block=job["row_block"],
                                         start_row=job["start_row"], device=device, mesh=mesh))
            undo()
            spans, cat = _stream_arrays(blocks)
            np.savez(os.path.join(outdir, f"{job['tag']}.{rank}.npz"), spans=np.asarray(spans),
                     rows=cat[0], cols=cat[1], d=cat[2], filt=cat[3], nn=cat[4])
            extra["engines"] = made
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = {"wall": wall, "counts": read_counts(), "bytes": mesh_mod.COLLECTIVE_BYTES,
               "peak": torch.cuda.max_memory_allocated(device), **extra}
        if job["kind"] == "sweep" and rank == 0:
            # one shard's ring block: rank 0's stripe against rank 1's, on this
            # rank's word shard, the K1 call of a ring step at the mesh's shape
            comp = _cached_compact(packed, packed)
            sa = _split_pair(packed if comp is None else comp[0], None)[0]
            ranks = allpairs._Ranks(mesh)
            B = mesh_mod.pad_to(sa.n_seqs, ranks.dp) // ranks.dp
            a = allpairs._Shard(sa, 0, B, ranks, device)
            b = allpairs._Shard(sa, B, B, ranks, device)
            args = (a.ex, a.nm, 0, B, 0, b.ex, b.nm)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = kernels.split_gram_reference(*args)
            end.record()
            got = kernels.split_gram(*args)
            torch.cuda.synchronize()
            rec["shard"] = {
                "B": B, "W": int(a.ex.shape[2]),
                "max_abs_err": [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)],
                "ms": time_ms(lambda: kernels.split_gram(*args), 10),
                "plain_ms": start.elapsed_time(end)}
            lib_ms, _, lib = library_split_gram(*args)
            rec["shard"].update(library_ms=lib_ms, library_equal=all(
                torch.equal(x, y) for x, y in zip(lib, got)))
            del got, want, a, b, lib
        with open(os.path.join(outdir, f"{job['tag']}.{rank}.json"), "w") as fh:
            json.dump(rec, fh)
        dist.barrier()  # rank 0's shard check ends before any rank goes on
    dist.destroy_process_group()


def _run_world(n: int, jobs: list, tmp: str, name: str) -> list:
    """Spawns ``n`` gloo ranks running ``jobs``; fails the phase if one exits
    non-zero or the world outlives MESH_WORLD_TIMEOUT (every rank is then
    killed).  Returns {tag: [each rank's record]}."""
    import multiprocessing as mp

    outdir = os.path.join(tmp, f"mesh_{name}")
    os.makedirs(outdir)
    url = f"file://{os.path.join(outdir, 'store')}"
    repo = os.path.dirname(os.path.abspath(__file__))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, n, url, jobs, outdir, repo))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_WORLD_TIMEOUT
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        fail(f"mesh world {name}: rank exit codes {codes} (killed ranks show -9)")
    recs = {}
    for job in jobs:
        recs[job["tag"]] = []
        for r in range(n):
            with open(os.path.join(outdir, f"{job['tag']}.{r}.json")) as fh:
                recs[job["tag"]].append(json.load(fh))
    return recs


def _ring_plan(what: str, peaks: list, plan: tuple) -> None:
    """Prints a ring run's peak device allocation per rank against the plan
    ``RingCoo.fits`` made, (stripes, operands, the temporaries' budget), and
    fails if a rank's peak exceeds the plan's total."""
    stripes, operands, chunk = plan
    print(f"# mesh {what}: peak device allocation per rank "
          f"{', '.join(f'{p:,}' for p in peaks)} B against the ring's plan: stripes "
          f"(RingCoo.stripe_bytes) {stripes:,} + operands {operands:,} = "
          f"{stripes + operands:,} B, {max(peaks) / (stripes + operands):.3f} of it, "
          f"+ {chunk:,} B of temporaries' budget")
    if max(peaks) > stripes + operands + chunk:
        fail(f"mesh {what}: a rank's peak allocation {max(peaks):,} B exceeds the ring's plan")


def _report(what: str, recs: list, expect_split: int, expect_coo: int) -> dict:
    """Prints a run's wall, peak allocation and collective bytes over its
    ranks; fails unless every rank launched ``expect_split`` split-gram
    kernels and as many correction grams (the headline has partial-IUPAC
    columns), and ``expect_coo`` extractions.  Returns each kernel's launches
    summed over the ranks."""
    walls = [r["wall"] for r in recs]
    launches = {k: [r["counts"][k] for r in recs]
                for k in ("split_gram", "partial_gram", "coo_extract", "mism_positions")}
    print(f"# mesh {what}: wall {max(walls):.3f} s (ranks {', '.join(f'{w:.3f}' for w in walls)}),"
          f" peak device allocation per rank "
          f"{', '.join(f'{r["peak"] / 1e9:.2f}' for r in recs)} GB, bytes through the "
          f"collectives {sum(r['bytes'] for r in recs):,}, launches a rank "
          f"{', '.join(f'{k} {v}' for k, v in launches.items())}")
    want = {"split_gram": expect_split, "partial_gram": expect_split, "coo_extract": expect_coo}
    for k, n in want.items():
        if launches[k] != [n] * len(recs):
            fail(f"mesh {what}: {k} launches {launches[k]}, {n} expected a rank")
    return {k: sum(v) for k, v in launches.items()}


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def phase_mesh(packed, fasta: str, cache: str, row_block: int, sha_plain: str,
               sha_filter: str, tmp: str, device, card):
    """The mesh (parallel/) at the headline size, the planes from phase 3's
    pack cache.  (a) nccl in a world of one, in this process: the ring and
    the block sweep over a 1 x 1 mesh through ``pairsnp_stream(mesh=...)``,
    each equal to the one-device stream.  (b) gloo ranks sharing cuda:0,
    each calling ``initialize(..., backend="gloo")`` then the ``distance``
    CLI: ``--mesh 2x1`` (the ring), ``--mesh 1x2`` (sp only) and ``--mesh
    2x2 --filter``, whose every CSV (``.procN`` included) must hash to phase
    3's (phase 7's with ``--filter``); then the block sweep through the API
    from row 1024 on 2 x 2, equal to the one-device arrays, and one shard's
    ring block against ``split_gram_reference``.  Nothing here is a scaling
    number: the ranks share one card's SMs and talk through host memory.
    Returns (the 2 x 2 run's launches of each kernel over its ranks, the
    split-gram kernel's record at the shard's shape)."""
    import datetime

    import torch
    import torch.distributed as dist

    from tracs_tpu_torch.ops import kernels
    from tracs_tpu_torch.ops.packing import pack_fasta
    from tracs_tpu_torch.ops.pairsnp import _cached_compact, pairsnp_stream
    from tracs_tpu_torch.parallel import allpairs, mesh as mesh_mod, multihost

    n = packed.n_seqs
    props = torch.cuda.get_device_properties(device)
    print(f"# mesh: card memory {props.total_memory:,} B; the ring plans with "
          f"{allpairs.device_bytes(device):,} B (less {allpairs._CUDA_HEADROOM_BYTES:,} B "
          f"of headroom)")
    # the ring's plan at a shape, on the compacted split layout the stream uses
    comp = _cached_compact(packed, packed)
    n_words = (packed if comp is None else comp[0]).planes.shape[2]

    def plan(shape):
        return (allpairs.RingCoo.stripe_bytes(n, shape),
                allpairs.RingCoo.operand_bytes(n, shape, n_words), allpairs._CHUNK_BYTES_BUDGET)
    torch.cuda.empty_cache()

    # (a) nccl, a world of one
    url = f"file://{os.path.join(tmp, 'nccl_store')}"
    if multihost.initialize(url, 1, 0, device=device) is not False:
        fail("initialize set up a group for one process")
    multihost.init_group(url, 1, 0, device=device, timeout=datetime.timedelta(seconds=300))
    try:
        if dist.get_backend() != "nccl":
            fail(f"the world of one runs on {dist.get_backend()}, not nccl")
        mesh = mesh_mod.make_mesh(1, 1)
        pc = pack_fasta(fasta, cache_dir=cache)
        if not np.array_equal(pc.planes, packed.planes):
            fail("the pack cache's planes differ from the headline's")
        made, undo = _spy_engines()
        single = {}
        for start in (0, 1024):
            for on_mesh in (False, True):
                reset_counts()
                mesh_mod.COLLECTIVE_BYTES = 0
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                blocks = list(pairsnp_stream([pc], dist=200, row_block=row_block,
                                             start_row=start, device=device,
                                             mesh=mesh if on_mesh else None))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if on_mesh and start == 0:  # the ring: its growth over what was resident
                    _ring_plan("(a) 1x1 ring", [torch.cuda.max_memory_allocated(device) - base],
                               plan((1, 1)))
                spans, cat = _stream_arrays(blocks)
                what = f"{'1x1 mesh' if on_mesh else 'one device'} from row {start}"
                print(f"# mesh (a) nccl, {what}: {wall:.3f} s, {len(blocks)} blocks, "
                      f"{len(cat[0])} pairs, split_gram launches "
                      f"{launches('split_gram')}, partial_gram launches "
                      f"{launches('partial_gram')}, coo_extract launches "
                      f"{launches('coo_extract')}, bytes through nccl "
                      f"{mesh_mod.COLLECTIVE_BYTES:,}")
                # a world of one: the ring's one stripe is its one block
                if launches("coo_extract") != len(blocks) or \
                        launches("partial_gram") != launches("split_gram"):
                    fail(f"mesh (a), {what}: {launches('coo_extract')} coo_extract "
                         f"launches for {len(blocks)} blocks, {launches('partial_gram')} "
                         f"partial_gram for {launches('split_gram')} split_gram")
                if not on_mesh:
                    single[start] = (spans, cat)
                    continue
                if not all(np.array_equal(x, y) for x, y in zip(cat, single[start][1])):
                    fail(f"mesh (a): the {what} arrays differ from the one-device stream")
                if start and spans != single[start][0]:
                    fail(f"mesh (a): the {what} blocks differ from the one-device stream")
        undo()
        if made != ["RingCoo", "ShardedSweep"]:
            fail(f"mesh (a): engines {made}, want the ring from row 0 and the sweep from 1024")
        print("# mesh (a): the ring and the block sweep over nccl equal the one-device stream")
    finally:
        dist.destroy_process_group()
    del pc
    torch.cuda.empty_cache()

    # (b) gloo ranks on cuda:0
    def cli_job(tag, mesh_spec, *extra):
        out = os.path.join(tmp, f"mesh_{tag}.csv")
        return {"kind": "cli", "tag": tag, "out": out,
                "argv": ["distance", "--msa", fasta, "-o", out, "-D", "200", "--row-block",
                         str(row_block), "--pack-cache", cache, "--mesh", mesh_spec, *extra,
                         "--device", "cuda"]}

    def check_csvs(job, ranks: int, want: str):
        paths = [job["out"]] + [f"{job['out']}.proc{r}" for r in range(1, ranks)]
        shas = [_sha(p) for p in paths]
        print(f"# mesh {job['tag']}: CSV sha256 {', '.join(h[:8] + '...' for h in shas)} "
              f"(want {want[:8]}...)")
        if any(h != want for h in shas):
            fail(f"mesh {job['tag']}: a rank's CSV differs from the one-device run's")
        for p in paths:
            os.remove(p)

    t0 = time.perf_counter()
    jobs_a = [cli_job("2x1", "2x1"), cli_job("1x2", "1x2")]
    recs = _run_world(2, jobs_a, tmp, "two")
    print(f"# mesh world of 2 gloo ranks: {time.perf_counter() - t0:.3f} s with start-up")
    _report("2x1 (the ring)", recs["2x1"], 2, 1)
    _report("1x2 (sp only)", recs["1x2"], 1, 1)
    for tag, shape in (("2x1", (2, 1)), ("1x2", (1, 2))):
        _ring_plan(f"{tag} ring (the whole CLI run)", [r["peak"] for r in recs[tag]],
                   plan(shape))
    check_csvs(jobs_a[0], 2, sha_plain)
    check_csvs(jobs_a[1], 2, sha_plain)

    t0 = time.perf_counter()
    sweep = {"kind": "sweep", "tag": "sweep", "fasta": fasta, "cache": cache, "shape": (2, 2),
             "row_block": row_block, "start_row": 1024}
    jobs_b = [cli_job("2x2f", "2x2", "--filter"), sweep]
    recs = _run_world(4, jobs_b, tmp, "four")
    print(f"# mesh world of 4 gloo ranks: {time.perf_counter() - t0:.3f} s with start-up")
    mesh_launches = _report("2x2 --filter", recs["2x2f"], 2, 1)
    tiled = [r["counts"]["mism_positions (tiled)"] for r in recs["2x2f"]]
    print(f"# mesh 2x2 --filter: the tiled mismatch-position kernel's launches a rank "
          f"{', '.join(map(str, tiled))}")
    if any(r["counts"]["mism_positions"] < 1 for r in recs["2x2f"]):
        fail("mesh 2x2 --filter: a rank did not launch the mismatch-position kernel")
    if any(r["counts"]["mism_positions"] != t for r, t in zip(recs["2x2f"], tiled)):
        fail("mesh 2x2 --filter: a rank launched the warp kernel on its clustered blocks, where "
             "the rule should take the tiled kernel every time")
    check_csvs(jobs_b[0], 4, sha_filter)
    blocks = -(-(n - 1024) // row_block)
    _report("2x2 block sweep from row 1024", recs["sweep"], blocks, blocks)
    spans, cat = single[1024]
    for r in range(4):
        got = np.load(os.path.join(tmp, "mesh_four", f"sweep.{r}.npz"))
        if recs["sweep"][r]["engines"] != ["ShardedSweep"]:
            fail(f"mesh sweep: rank {r} built {recs['sweep'][r]['engines']}")
        if [tuple(x) for x in got["spans"].tolist()] != spans or not all(
                np.array_equal(got[k], c) for k, c in zip(("rows", "cols", "d", "filt", "nn"),
                                                          cat)):
            fail(f"mesh sweep: rank {r}'s arrays differ from the one-device stream")
    print(f"# mesh sweep from row 1024 on 2x2: every rank's arrays equal the one-device "
          f"stream's ({len(cat[0])} pairs)")
    shard = recs["sweep"][0]["shard"]
    name = f"a ring block of the 2x2 mesh B={shard['B']} W={shard['W']}"
    print(f"# split_gram (mesh path) vs plain, {name}: max |err| {shard['max_abs_err']}; "
          f"kernel {shard['ms']:.3f} ms, plain {shard['plain_ms']:.3f} ms (one run)")
    if any(shard["max_abs_err"]):
        fail(f"split_gram disagrees with its plain version at {name}")
    print(f"# split_gram (mesh path) at {name}: torch._int_mm G4 + Gn {shard['library_ms']:.3f} "
          f"ms (int8 operands unpacked beforehand, not counted)")
    if not shard["library_equal"]:
        fail(f"torch._int_mm's G4 - Gn and Gn differ from split_gram's at {name}")
    rec = {k: shard[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms")}
    rec.update(gram_bound(f"split_gram (mesh path) at {name}", shard["B"], shard["B"],
                          shard["W"], 0, shard["B"], 0, planes=5, products=5, popc=5, card=card,
                          peak_ops=PEAK_B1))
    return mesh_launches, rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096, help="samples (default 4096)")
    ap.add_argument("--length", type=int, default=1_000_000, help="sites (default 1 Mb)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the kernel sources csrc/<name>.cu; the last is the yardstick of phase 1,
    # not a kernel of any path
    from tracs_tpu_torch.runtime.build import KERNELS, build_cuda_library

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# card: {smi}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    def build(name):
        t0 = time.perf_counter()
        path, log = build_cuda_library(name)
        return time.perf_counter() - t0, path, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(build, KERNELS)))
    print(f"# built {len(KERNELS)} kernels in parallel: {time.perf_counter() - t0:.2f} s")
    for name, (secs, path, log) in builds.items():
        print(f"# build {name}.cu: {secs:.2f} s -> {os.path.relpath(path)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"#   {line.strip()}")

    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    card = {"sms": props.multi_processor_count, "sm_hz": sm_mhz * 1e6}
    print(f"# {card['sms']} SMs, max SM clock {sm_mhz:.0f} MHz")

    phase_doctor()
    recs = phase_kernels(device, args.seed, card)
    with tempfile.TemporaryDirectory() as tmp:
        packed, fasta, cluster_size = _headline(args.n, args.length, args.seed, tmp)
        slice_launches, fields, sha_plain = phase_slice(packed, fasta, cluster_size, ROW_BLOCK,
                                                        args.seed, tmp, device)
        bench_launches = phase_bench(packed, len(fields), device)
        cache = phase_pack_cache(fasta, args.n, ROW_BLOCK, os.path.join(tmp, "dists.csv"), tmp,
                                 device)
        ((pc_launches, pc_coo_launches), recs["mism_positions"],
         ((mxu_launches, mxu_coo_launches), recs["mxu route"])) = phase_sweeps(
            fasta, ROW_BLOCK, device, card)
        _, meta_launches, N, years = phase_meta(packed, fasta, cluster_size, ROW_BLOCK,
                                                args.seed, tmp, fields, device)
        recs["trans_k_loop"] = phase_trans_dist(N, years, device)
        phase_transcluster_bench(device)
        filter_launches, sha_filter = phase_filter(packed, fasta, ROW_BLOCK, args.seed, tmp,
                                                   fields, device)
        mesh_launches, recs["split_gram (mesh path)"] = phase_mesh(
            packed, fasta, cache, ROW_BLOCK, sha_plain, sha_filter, tmp, device, card)
    del packed, fields
    phase_planted(args.length, args.seed, device)
    exp_counts = phase_experiments(args.n, args.length, device, card, recs)
    with tempfile.TemporaryDirectory() as tmp:
        pipe_launches, recs["split_gram at pipe's shape"] = phase_pipe(args.seed, tmp, device,
                                                                       card)

    def entry(name, kernel, source, replaces, launches, outputs=None):
        rec = dict(recs[kernel])
        err = rec.pop("max_abs_err")
        library_ms = rec.pop("library_ms", None)
        return {"name": name, "route": "cuda", "source": f"tracs_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err if outputs is None else max(err[k] for k in outputs),
                **rec, "library_ms": library_ms}

    from tracs_tpu_torch.ops import kernels as K

    pallas = "tracs_tpu/ops/pallas_kernels.py"
    jax_pairsnp = "tracs_tpu/ops/pairsnp.py"
    # the other runs of the split engine: name, every kernel's launches there
    others = [("--meta run", meta_launches), ("--filter run", filter_launches),
              ("pipe path", pipe_launches), ("mesh path", mesh_launches)]
    # K2 and K3 are one fused kernel: both entries carry its launch count and
    # time, each with the error of its own output (matches, nunion).
    # library_ms: torch._int_mm's products for split_gram, its variants,
    # popcount_gram (the mxu engine's signed 15-subset gram and N gram) and
    # partial_gram, as the JAX package computes them outside its Pallas
    # kernels; no single PyTorch call computes coo_extract's or
    # mism_positions' function: null.
    print(json.dumps({"kernels": [
        entry("split_gram", "split_gram", "split_gram", f"{pallas}:157",
              slice_launches["split_gram"], (0, 1)),
        # the same kernel through the headline bench: its launches in the bench
        # phase (7 sweeps of 4 blocks), its error, times and bound at block 0
        entry("split_gram (bench path)", "split_gram", "split_gram", f"{pallas}:157",
              bench_launches["split_gram"], (0, 1)),
        # the same kernel on the reads-to-clusters path: its launches in the
        # pipe run, its error, times and bound at that run's shape
        entry("split_gram (pipe path)", "split_gram at pipe's shape", "split_gram",
              f"{pallas}:157", pipe_launches["split_gram"], (0, 1)),
        # the same kernel on the mesh path: its launches over the four gloo
        # ranks of the 2x2 --filter run, error, times and bound at one ring
        # block of that mesh (rank 0's stripe against rank 1's, a word shard)
        entry("split_gram (mesh path)", "split_gram (mesh path)", "split_gram",
              f"{pallas}:157", mesh_launches["split_gram"], (0, 1)),
        entry("popcount_gram (K2 matches)", "popcount_gram", "popcount_gram", f"{pallas}:45",
              pc_launches, (0,)),
        entry("popcount_gram (K3 nunion)", "popcount_gram", "popcount_gram", f"{pallas}:65",
              pc_launches, (1,)),
        # the same kernel on the mxu engine's route: its launches in the mxu
        # sweep, its (g, gq) against _gram_mxu at that sweep's first block
        entry("popcount_gram (mxu route)", "mxu route", "popcount_gram", f"{pallas}:45",
              mxu_launches, (0, 1)),
        *(entry(f"split_gram_variant {name}", name, "split_gram_mma",
                "scripts/kernel_experiments.py:22", exp_counts[name], (0, 1))
          for name in (K.variant_name(*v) for v in K.SPLIT_GRAM_VARIANTS)),
        # the tiled kernel: its launches in the --filter run (every launch
        # there, or the run fails), its error over every check of phase 4, its
        # times, plain time and bound at the first block; the first version's
        # times there ride along as first_version_ms / first_version_device_ms
        entry("mism_positions", "mism_positions", "mism_positions",
              "tracs_tpu/ops/pairsnp.py:1501", filter_launches["mism_positions (tiled)"]),
        # the main path's two device steps after the grams, as hand-written
        # kernels: launches in the distance CLI run; error, times and bound
        # at the first block of the headline's sweep (phase 2)
        entry("partial_gram", "partial_gram", "partial_gram", f"{jax_pairsnp}:184",
              slice_launches["partial_gram"]),
        # its launches in the --meta and --filter runs, in the pipe run, and
        # over the four gloo ranks of the 2x2 --filter run
        *(entry(f"partial_gram ({what})", "partial_gram", "partial_gram", f"{jax_pairsnp}:184",
                launches["partial_gram"]) for what, launches in others),
        entry("partial_gram (bench path)", "partial_gram", "partial_gram", f"{jax_pairsnp}:184",
              bench_launches["partial_gram"]),
        entry("coo_extract", "coo_extract", "coo_extract", f"{jax_pairsnp}:928",
              slice_launches["coo_extract"]),
        # the split layout built on the card: no TPU kernel, it replaces the
        # host pass of split_alignment (src/tracs_native.cpp tn_split_stats);
        # launches in the distance CLI run, error and times at 4096 x 31250
        entry("split_layout", "split_layout", "split_layout",
              "none (the host pass tracs_tpu/ops/packing.py::split_alignment)",
              slice_launches["split_layout"]),
        entry("split_layout (gather)", "split_gather", "split_layout",
              "none (the host pass tracs_tpu/ops/packing.py::split_alignment)",
              slice_launches["split_gather"]),
        # the transmission model's k loop: no TPU kernel, it replaces the
        # blocked elementwise loop (XLA code in tracs_tpu); launches in the
        # --meta run, error and times at one lookup of a job's lanes
        entry("trans_k_loop", "trans_k_loop", "trans_k_loop",
              "none (the k loop of tracs_tpu/models/transcluster.py, XLA code)",
              meta_launches["trans_k_loop"]),
        *(entry(f"coo_extract ({what})", "coo_extract", "coo_extract", f"{jax_pairsnp}:928",
                launches["coo_extract"]) for what, launches in others[:3]),
        entry("coo_extract (bench path)", "coo_extract", "coo_extract", f"{jax_pairsnp}:928",
              bench_launches["coo_extract"]),
        # the same kernel in direct mode (D = L - matches): its launches in the
        # cold popcount sweep and in the mxu sweep, its error, times and bound
        # in that mode at the first block
        entry("coo_extract (popcount path)", "coo_extract (direct)", "coo_extract",
              f"{jax_pairsnp}:928", pc_coo_launches),
        entry("coo_extract (mxu route)", "coo_extract (direct)", "coo_extract",
              f"{jax_pairsnp}:928", mxu_coo_launches),
        # split mode without a correction gram (the mesh folds it into g before
        # the sp sum): its launches over the ranks of the 2x2 --filter run
        entry("coo_extract (mesh path)", "coo_extract (split)", "coo_extract",
              f"{jax_pairsnp}:928", mesh_launches["coo_extract"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
