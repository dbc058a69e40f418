"""Hand-written device kernels of the port and their plain PyTorch versions
(counterpart of tracs_tpu/ops/pallas_kernels.py).

``split_gram`` — the split-decomposition grams of a row block against a
column suffix, ``g = G4 - Gn`` and ``gn = Gn`` (see ops/pairsnp.py), from
the CUDA kernel ``csrc/split_gram.cu`` (b1 ``mma.sync`` on the packed words,
fed by a ``cp.async`` ring).

``popcount_gram`` — the popcount engine: match counts
``sum popc(OR_x(a_x & b_x))`` and N-union counts ``sum popc(N_a | N_b)``
over the raw planes, both from the one CUDA kernel
``csrc/popcount_gram.cu`` (the 15 plane-subset grams of the
inclusion-exclusion as b1 ``mma.sync`` on subset operands formed in
registers, fed by TMA loads through an mbarrier ring).

``split_gram_variant`` — the same two grams as ``split_gram`` from the
tensor-core kernels ``csrc/split_gram_mma.cu`` (``wgmma`` on b1 operands for
``b1-128``, ``mma.sync`` on b1, int8 or bf16 operands for the others: the
H100 forms of the TPU's unpack-and-dot experiment kernels).

``mismatch_positions_kernel`` — per pair of samples, the count and the
ascending positions of the sites where the two share no allele, from the
CUDA kernels ``csrc/mism_positions.cu`` (the recombination filter's device
step): tiles of consecutive pairs that stage each of their samples' rows
once, with the word axis cut into parts across the card, or, where tiles
cannot pay (``mism_design``), a warp a pair.

``partial_gram`` — the split engine's correction gram over the partial-IUPAC
sites (the 10 plane-pair and plane-triple AND grams, signed), from the CUDA
kernel ``csrc/partial_gram.cu`` (the 10 grams as b1 ``mma.sync`` on subset
operands formed in registers, on ``popcount_gram``'s TMA ring, shared through
``csrc/plane_ring.cuh``).

``coo_extract`` — one block's D/NN assembly, threshold, triangle mask and
row-major COO compaction, from the CUDA kernel ``csrc/coo_extract.cu`` in one
launch (count, a single-pass scan by decoupled look-back, emit; no D or NN
block is written, the output is sized on the host by ``coo_capacity``);
``coo_extract_launch`` queues the same launch and returns it pending, so the
sweep can queue the next block before it takes this one's survivors.

``split_layout`` and ``split_gather`` — the split engine's layout (N-exclusive
planes, N masks and counts, the partial-site OR) from the raw planes in one
pass, and its partial planes gathered at the partial sites, from the two
kernels of ``csrc/split_layout.cu``: the host pass they replace on the card
is ops/packing.py::split_alignment's.

``trans_k_loop`` — the transmission model's k loop, from the CUDA kernel
``csrc/trans_k_loop.cu`` in one launch (a thread a lane, its recurrence in
float64 registers to its own exit).  It takes CUDA tensors only: its plain
version is the model's blocked engine
(models/transcluster.py::_k_loop_blocked), and the model picks between them.

On a CUDA tensor each wrapper launches its kernel (built for sm_90a at first
use, runtime/build.py) and counts the launch in the counter
``kernel.launches.<kernel>`` of runtime/profiling.py (``split_gram``,
``popcount_gram``, ``split_gram_mma.<variant>``, ``mism_positions`` and, for
the tiled design also, ``mism_positions_tiled``, ``partial_gram``,
``coo_extract``, ``split_layout``, ``split_gather``, ``trans_k_loop``); on a
CPU tensor it returns its ``*_reference``, the plain exact version.  There is no fallback from one to the other.

Layouts: packed words are ``int32`` tensors holding the bits of the uint32
planes; the kernel reads them as ``uint32``.  The gram kernels copy their
operands (the split layout's [n, 4, W] planes and [n, W] masks, the popcount
engine's [n, 4, W] raw planes, the split layout's [n, 4, Wp] partial planes)
to shared memory 16 bytes at a time, so on the card the word pitch ``W`` is
a multiple of ``LAYOUT_WORD_MULTIPLE`` and the storage 16-byte aligned:
``pad_layout`` and ``pad_planes`` add the zero words, which add nothing to
any count, and a CUDA operand that breaks the rule is refused, not copied.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from tracs_tpu_torch.runtime.device import resolve_device, to_host
from tracs_tpu_torch.runtime.profiling import count

#: the tensor-core split-gram variants as (dot, tile, unpack): the operand
#: type of the ``mma``, the block's square output tile, and for ``s8`` the
#: routine that unpacks a word to int8 ("shift": bits j, j+8, j+16, j+24 by
#: one shift and mask; "nibble": one nibble spread over 4 bytes by a multiply)
SPLIT_GRAM_VARIANTS = (
    ("b1", 64, None), ("b1", 128, None),
    ("s8", 128, "shift"), ("s8", 128, "nibble"),
    ("bf16", 128, None),
)
# the kernel's code for each (dot, unpack)
_VARIANT_DOT_CODES = {("b1", None): 0, ("s8", "shift"): 1, ("s8", "nibble"): 2,
                      ("bf16", None): 3}


def variant_name(dot: str, tile: int, unpack: str | None = None) -> str:
    """``b1-64``, ``s8-shift-128``, ...: the variant's name in its launch
    counter ``kernel.launches.split_gram_mma.<name>``."""
    return f"{dot}-{unpack}-{tile}" if unpack else f"{dot}-{tile}"


#: words between two flushes of the bf16 variant's f32 accumulators to int32.
#: An exclusive-plane site adds at most 3 to a count (a 3-bit IUPAC code on
#: both sides), so 3 * 32 * 131072 = 12,582,912 stays below 2^24, where f32
#: stops holding every integer.
_BF16_FLUSH_WORDS = 131072

# words per chunk of the plain version: bounds the unpacked float64 operands
_REFERENCE_BYTES = 512 << 20

#: the word pitch of a gram kernel's operand on the card is a multiple of
#: this: 4 words are the 16 bytes of one ``cp.async`` piece, and TMA takes only
#: strides that are multiples of 16 bytes
LAYOUT_WORD_MULTIPLE = 4

#: parts into which ``split_gram``'s kernel cuts the word axis, each part a
#: block of its own that adds its sums to the outputs with integer atomics
#: (any order gives the same integers).  0: the launcher chooses from the
#: number of output tiles and the card's SM count, so that a narrow block
#: still fills the card; the card-only tests force other values.
_SPLIT_GRAM_WORD_SPLITS = 0
#: the same for ``popcount_gram``'s kernel
_POPCOUNT_GRAM_WORD_SPLITS = 0

#: ``popcount_gram``'s kernel sums up to 8 plane subsets of 32 sites a word in
#: one int32 accumulator: 256 * W stays below 2^31 for W below this
_POPCOUNT_GRAM_MAX_WORDS = 2**23


def _as_words(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy words as an int32 CPU tensor of the same bits.  The
    tensor shares the array's memory, which may be a read-only mmap (a pack
    cache entry): nothing in the port writes into packed planes."""
    words = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    if words.flags.writeable:
        return torch.from_numpy(words)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(words)


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 packed words -> [..., W*32] uint8 0/1 bits.

    Shifts a uint8 view of the words: torch has no ``>>`` for uint32 on the
    CPU.  Bits come out in byte-major order, the same permutation of the
    sites for every operand, which a contraction over sites cannot see."""
    b = words.contiguous().view(torch.uint8)  # [..., W*4]
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((b.unsqueeze(-1) >> shifts) & 1).reshape(*words.shape[:-1], -1)


def padded_words(W: int) -> int:
    """The word pitch the card's split layout gives ``W`` words."""
    return -(-W // LAYOUT_WORD_MULTIPLE) * LAYOUT_WORD_MULTIPLE


def pad_layout(e: torch.Tensor, nm: torch.Tensor):
    """(e, nm) of a split layout ([n, 4, W] planes, [n, W] masks) with zero
    words appended up to a pitch of ``padded_words(W)``, on the tensors' own
    device; the tensors themselves when they already have that pitch.  Zero
    words add nothing to either gram and are past every site."""
    pad = padded_words(e.shape[-1]) - e.shape[-1]
    if pad == 0:
        return e, nm
    return torch.nn.functional.pad(e, (0, pad)), torch.nn.functional.pad(nm, (0, pad))


def pad_planes(p: torch.Tensor) -> torch.Tensor:
    """Raw planes [n, 4, W] with zero words appended up to a pitch of
    ``padded_words(W)``, on the tensor's own device; the tensor itself when it
    already has that pitch.  A zero word shares no allele and has N = 0, so it
    adds nothing to ``matches`` or ``nunion``; it does read as 32 mismatching
    sites, which only a length keeps out (``mismatch_positions_kernel``)."""
    pad = padded_words(p.shape[-1]) - p.shape[-1]
    return torch.nn.functional.pad(p, (0, pad)) if pad else p


def _check_pitch(tensors, words: int, what: str, helper: str) -> None:
    """Raises unless, off the CPU, the operand ``tensors`` of ``words`` words a
    row keep the gram kernels' rule: a word pitch that is a multiple of
    ``LAYOUT_WORD_MULTIPLE`` and 16-byte aligned storage."""
    if tensors[0].device.type == "cpu":
        return
    aligned = tensors[0].device.type != "cuda" or not any(t.data_ptr() % 16 for t in tensors)
    if words % LAYOUT_WORD_MULTIPLE or not aligned:
        raise ValueError(
            f"{what}: on the card a gram kernel's operand needs a word pitch that is a "
            f"multiple of {LAYOUT_WORD_MULTIPLE} and 16-byte aligned storage (the kernels copy "
            f"it 16 bytes at a time), got {words} words; pad it once with "
            f"tracs_tpu_torch.ops.kernels.{helper} and keep the result")


def _check_layout(e: torch.Tensor, nm: torch.Tensor, what: str, *,
                  pitch: bool = False) -> None:
    """Raises unless (e, nm) is a split layout; with ``pitch`` also unless, off
    the CPU, it keeps the gram kernels' rule: a word pitch that is a multiple
    of ``LAYOUT_WORD_MULTIPLE`` and 16-byte aligned storage."""
    if e.dtype != torch.int32 or nm.dtype != torch.int32:
        raise TypeError(f"{what}: packed words must be int32, got {e.dtype}/{nm.dtype}")
    if e.dim() != 3 or e.shape[1] != 4 or nm.dim() != 2:
        raise ValueError(f"{what}: want [n, 4, W] planes and [n, W] mask, got "
                         f"{tuple(e.shape)} and {tuple(nm.shape)}")
    if nm.shape[0] != e.shape[0] or nm.shape[1] != e.shape[2]:
        raise ValueError(f"{what}: mask {tuple(nm.shape)} does not match planes "
                         f"{tuple(e.shape)}")
    if not (e.is_contiguous() and nm.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")
    if pitch:
        _check_pitch((e, nm), e.shape[2], what, "pad_layout(e, nm)")


def _operands(ea, nm, r0, rb, c0, eb, nmb):
    """Validated (eb, nmb, m) for a split-gram call."""
    if (eb is None) != (nmb is None):
        raise ValueError("eb and nmb are given together or not at all")
    if eb is None:
        eb, nmb = ea, nm
    _check_layout(ea, nm, "A", pitch=True)
    _check_layout(eb, nmb, "B", pitch=True)
    if eb.shape[2] != ea.shape[2]:
        raise ValueError(f"A has {ea.shape[2]} words, B has {eb.shape[2]}")
    devices = {t.device for t in (ea, nm, eb, nmb)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    if not (0 <= r0 and 0 <= rb and r0 + rb <= ea.shape[0]):
        raise ValueError(f"rows [{r0}, {r0 + rb}) outside [0, {ea.shape[0]})")
    if not 0 <= c0 <= eb.shape[0]:
        raise ValueError(f"column start {c0} outside [0, {eb.shape[0]}]")
    return eb, nmb, eb.shape[0] - c0


def split_gram_reference(ea, nm, r0: int, rb: int, c0: int, eb=None, nmb=None):
    """Plain exact version of ``split_gram``: unpacks word chunks to 0/1 and
    contracts them in float64 (exact: every sum is an integer far below
    2^53), chunked so the unpacked operands stay under ~512 MB."""
    eb, nmb, m = _operands(ea, nm, r0, rb, c0, eb, nmb)
    a_e, a_n = ea[r0:r0 + rb], nm[r0:r0 + rb]
    b_e, b_n = eb[c0:], nmb[c0:]
    W = ea.shape[2]
    acc4 = torch.zeros((rb, m), dtype=torch.float64, device=ea.device)
    accn = torch.zeros((rb, m), dtype=torch.float64, device=ea.device)
    chunk = max(1, _REFERENCE_BYTES // max(1, (rb + m) * 5 * 32 * 8))
    for w0 in range(0, W, chunk):
        w1 = min(W, w0 + chunk)
        xa = _unpack_bits(a_e[:, :, w0:w1]).reshape(rb, -1).to(torch.float64)
        xb = _unpack_bits(b_e[:, :, w0:w1]).reshape(m, -1).to(torch.float64)
        acc4 += xa @ xb.T
        del xa, xb
        na = _unpack_bits(a_n[:, w0:w1]).to(torch.float64)
        nb = _unpack_bits(b_n[:, w0:w1]).to(torch.float64)
        accn += na @ nb.T
    return (acc4 - accn).to(torch.int32), accn.to(torch.int32)


def _kernel_entry(name: str, argtypes, symbol: str | None = None, restype=ctypes.c_int):
    """C function ``tracs_<symbol>`` (default ``tracs_<name>``, the entry
    point) of the kernel library ``csrc/<name>.cu``, built and typed on
    first use."""
    from tracs_tpu_torch.runtime.build import load_cuda_library

    fn = getattr(load_cuda_library(name), f"tracs_{symbol or name}")
    if fn.argtypes is None:
        fn.restype = restype
        fn.argtypes = argtypes
    return fn


def _launch(name: str, inputs, W: int, r0: int, rb: int, c0: int, m: int, extra=()):
    """Two int32 [rb, m] outputs of gram kernel ``name`` on the inputs' card
    and PyTorch's current stream; raises if the launch is refused.  The entry
    point takes the input pointers, W, r0, rb, c0, m, the ``extra`` ints, two
    output pointers and the stream."""
    dev = inputs[0].device
    out = (torch.empty((rb, m), dtype=torch.int32, device=dev),
           torch.empty((rb, m), dtype=torch.int32, device=dev))
    if rb == 0 or m == 0:
        return out
    fn = _kernel_entry(name, (
        [ctypes.c_void_p] * len(inputs) + [ctypes.c_longlong]
        + [ctypes.c_int] * (4 + len(extra)) + [ctypes.c_void_p] * 3
    ))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in inputs), W, r0, rb, c0, m, *extra,
                out[0].data_ptr(), out[1].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def _check_cuda(t: torch.Tensor, what: str, rows: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    if rows >= 2**31:
        raise ValueError("more rows than the kernel's int32 row indexing holds")


def split_gram(ea, nm, r0: int, rb: int, c0: int, eb=None, nmb=None):
    """Split-decomposition grams (g, gn), int32 [rb, n_b - c0], of rows
    [r0, r0+rb) of the A layout against rows [c0, n_b) of the B layout.

    ea, eb : int32 [n, 4, W] N-exclusive planes; nm, nmb : int32 [n, W] N
    masks.  ``eb``/``nmb`` default to ``ea``/``nm`` (the self all-pairs
    sweep); they are given for a query-vs-db rectangle.  The full
    device-resident layouts go in; no block is copied.  CPU tensors take
    ``split_gram_reference``; CUDA tensors launch the kernel or raise: their
    word pitch must be a multiple of ``LAYOUT_WORD_MULTIPLE`` (``pad_layout``
    makes it one; the wrapper pads nothing itself)."""
    if ea.device.type == "cpu":
        return split_gram_reference(ea, nm, r0, rb, c0, eb, nmb)
    eb, nmb, m = _operands(ea, nm, r0, rb, c0, eb, nmb)
    _check_cuda(ea, "split_gram", max(ea.shape[0], eb.shape[0]))
    out = _launch("split_gram", (ea, nm, eb, nmb), ea.shape[2], r0, rb, c0, m,
                  extra=(_SPLIT_GRAM_WORD_SPLITS,))
    if rb and m:
        count("kernel.launches.split_gram")
    return out


# ---------------------------------------------------------------------------
# the popcount engine (K2 + K3)
# ---------------------------------------------------------------------------

#: the 15 non-empty subsets of the 4 planes as bit masks, and the
#: inclusion-exclusion sign (-1)^(|S|+1) of each
_SUBSETS = list(range(1, 16))
_SUBSET_SIGNS = [1.0 if bin(s).count("1") % 2 else -1.0 for s in _SUBSETS]


def _check_planes(p: torch.Tensor, what: str) -> None:
    if p.dtype != torch.int32:
        raise TypeError(f"{what}: packed words must be int32, got {p.dtype}")
    if p.dim() != 3 or p.shape[1] != 4:
        raise ValueError(f"{what}: want [n, 4, W] planes, got {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError(f"{what}: tensors must be contiguous")


def _popcount_operands(pa, r0, rb, c0, pb):
    """Validated (pb, m) for a popcount-gram call."""
    if pb is None:
        pb = pa
    _check_planes(pa, "A")
    _check_planes(pb, "B")
    _check_pitch((pa,), pa.shape[2], "A", "pad_planes(p)")
    _check_pitch((pb,), pb.shape[2], "B", "pad_planes(p)")
    if pb.shape[2] != pa.shape[2]:
        raise ValueError(f"A has {pa.shape[2]} words, B has {pb.shape[2]}")
    if pa.device != pb.device:
        raise ValueError(f"operands on several devices: {pa.device}, {pb.device}")
    if not (0 <= r0 and 0 <= rb and r0 + rb <= pa.shape[0]):
        raise ValueError(f"rows [{r0}, {r0 + rb}) outside [0, {pa.shape[0]})")
    if not 0 <= c0 <= pb.shape[0]:
        raise ValueError(f"column start {c0} outside [0, {pb.shape[0]}]")
    return pb, pb.shape[0] - c0


def _subset_products(p: torch.Tensor) -> torch.Tensor:
    """[n, 4, w] planes -> [n, 15, w]: the AND over each non-empty plane
    subset, subset s at channel s - 1 (so channel 14 is the N mask)."""
    prods = {1: p[:, 0], 2: p[:, 1], 4: p[:, 2], 8: p[:, 3]}
    for s in _SUBSETS:
        if s not in prods:
            low = s & -s
            prods[s] = prods[low] & prods[s ^ low]
    return torch.stack([prods[s] for s in _SUBSETS], dim=1)


def popcount_gram_reference(pa, r0: int, rb: int, c0: int, pb=None):
    """Plain exact version of ``popcount_gram``, independent of the kernel's
    OR-of-ANDs: by inclusion-exclusion over the OR,

        matches = sum over the 15 plane subsets S of
                  (-1)^(|S|+1) * gram(AND_{x in S} a_x, AND_{x in S} b_x)
        nunion  = cnt_N(a) + cnt_N(b) - gram(N_a, N_b),

    each gram a float64 contraction of unpacked 0/1 bits (exact: every sum
    is an integer far below 2^53), chunked over words so the unpacked
    operands stay under ~512 MB."""
    pb, m = _popcount_operands(pa, r0, rb, c0, pb)
    a, b = pa[r0:r0 + rb], pb[c0:]
    W = pa.shape[2]
    f64 = dict(dtype=torch.float64, device=pa.device)
    signs = torch.tensor(_SUBSET_SIGNS, **f64)[None, :, None]
    accm = torch.zeros((rb, m), **f64)
    accn = torch.zeros((rb, m), **f64)
    cnt_a = torch.zeros(rb, **f64)
    cnt_b = torch.zeros(m, **f64)
    chunk = max(1, _REFERENCE_BYTES // max(1, (2 * rb + m) * 16 * 32 * 8))
    for w0 in range(0, W, chunk):
        w1 = min(W, w0 + chunk)
        xa = _unpack_bits(_subset_products(a[:, :, w0:w1])).to(torch.float64)
        xb = _unpack_bits(_subset_products(b[:, :, w0:w1])).to(torch.float64)
        accm += (xa * signs).reshape(rb, -1) @ xb.reshape(m, -1).T
        na, nb = xa[:, -1], xb[:, -1]
        accn += na @ nb.T
        cnt_a += na.sum(dim=1)
        cnt_b += nb.sum(dim=1)
        del xa, xb, na, nb
    nunion = cnt_a[:, None] + cnt_b[None, :] - accn
    return accm.to(torch.int32), nunion.to(torch.int32)


def popcount_gram(pa, r0: int, rb: int, c0: int, pb=None):
    """(matches, nunion), int32 [rb, n_b - c0], of rows [r0, r0+rb) of the
    raw planes ``pa`` against rows [c0, n_b) of ``pb``.

    pa, pb : int32 [n, 4, W] raw packed planes; ``pb`` defaults to ``pa``
    (the self all-pairs sweep, c0 = r0 for its triangle blocks) and is
    given for a query-vs-db rectangle (c0 = 0).  The full device-resident
    planes go in; no block is copied.  CPU tensors take
    ``popcount_gram_reference``; CUDA tensors launch the kernel or raise:
    their word pitch must be a multiple of ``LAYOUT_WORD_MULTIPLE``
    (``pad_planes`` makes it one; the wrapper pads nothing itself) and below
    ``_POPCOUNT_GRAM_MAX_WORDS``, the range of the kernel's int32 sums."""
    if pa.device.type == "cpu":
        return popcount_gram_reference(pa, r0, rb, c0, pb)
    pb, m = _popcount_operands(pa, r0, rb, c0, pb)
    _check_cuda(pa, "popcount_gram", max(pa.shape[0], pb.shape[0]))
    if pa.shape[2] >= _POPCOUNT_GRAM_MAX_WORDS:
        raise ValueError(f"popcount_gram: {pa.shape[2]} words a row; the kernel's int32 sums "
                         f"hold fewer than {_POPCOUNT_GRAM_MAX_WORDS}")
    out = _launch("popcount_gram", (pa, pb), pa.shape[2], r0, rb, c0, m,
                  extra=(_POPCOUNT_GRAM_WORD_SPLITS,))
    if rb and m:
        count("kernel.launches.popcount_gram")
    return out


def snp_distance_popcount(a, b=None, *, device):
    """(D, NN) int32 numpy [n_a, n_b] of two PackedAlignments (b defaults
    to a) through the popcount engine: D = L - matches, NN = L - nunion
    (counterpart of tracs_tpu.ops.pallas_kernels.snp_distance_pallas)."""
    device = resolve_device(device)
    if b is None:
        b = a
    if a.length != b.length:
        raise ValueError("alignments must share sequence length")
    pa = pad_planes(_as_words(a.planes).to(device))
    pb = None if b is a else pad_planes(_as_words(b.planes).to(device))
    matches, nunion = popcount_gram(pa, 0, a.n_seqs, 0, pb)
    L = a.length
    return to_host(L - matches).astype(np.int32), to_host(L - nunion).astype(np.int32)


# ---------------------------------------------------------------------------
# the tensor-core split-gram variants (K1')
# ---------------------------------------------------------------------------

def _check_variant(dot: str, tile: int, unpack: str | None) -> str | None:
    """The unpack routine of a variant (``s8`` defaults to "shift"); raises
    for a combination the kernel source does not build."""
    if dot == "s8" and unpack is None:
        unpack = "shift"
    if (dot, tile, unpack) not in SPLIT_GRAM_VARIANTS:
        raise ValueError(
            f"no split-gram variant dot={dot!r} tile={tile!r} unpack={unpack!r}; "
            f"built: {[variant_name(*v) for v in SPLIT_GRAM_VARIANTS]}")
    return unpack


def split_gram_variant_reference(ea, nm, r0: int, rb: int, c0: int, eb=None, nmb=None,
                                 *, dot: str):
    """Plain exact version of ``split_gram_variant``, repeating the
    arithmetic of each operand type:

    * ``b1``: ``split_gram_reference`` (bits contracted as bits);
    * ``s8``: 0/1 int8 operands contracted with int32 accumulation
      (``torch.mm`` of int8 returns int8 and wraps, so the operands are
      widened first; CUDA has no int32 ``mm``, so there the contraction runs
      in float64, exact);
    * ``bf16``: operands 0.0 / 2.0 in ``torch.bfloat16`` (what the kernel
      feeds its ``mma``), widened to float32 and contracted in float32 per
      chunk of at most ``_BF16_FLUSH_WORDS`` words, each chunk's product
      scaled by 1/4 and cast to int32 before it is added.  A bf16 ``torch.mm``
      would return bf16, which is not exact above 256."""
    if dot == "b1":
        return split_gram_reference(ea, nm, r0, rb, c0, eb, nmb)
    if dot not in ("s8", "bf16"):
        raise ValueError(f"unknown dot {dot!r}")
    eb, nmb, m = _operands(ea, nm, r0, rb, c0, eb, nmb)
    a_e, a_n = ea[r0:r0 + rb], nm[r0:r0 + rb]
    b_e, b_n = eb[c0:], nmb[c0:]
    W = ea.shape[2]
    if dot == "s8":
        work = torch.int32 if ea.device.type == "cpu" else torch.float64

        def operand(words, rows):
            return _unpack_bits(words).to(torch.int8).reshape(rows, -1).to(work)

        def product(xa, xb):
            return (xa @ xb.T).to(torch.int32)
        item = 8
    else:
        def operand(words, rows):
            x = (_unpack_bits(words).to(torch.bfloat16) * 2.0).reshape(rows, -1)
            return x.to(torch.float32)

        def product(xa, xb):
            return ((xa @ xb.T) * 0.25).to(torch.int32)
        item = 4
    acc4 = torch.zeros((rb, m), dtype=torch.int32, device=ea.device)
    accn = torch.zeros((rb, m), dtype=torch.int32, device=ea.device)
    chunk = max(1, _REFERENCE_BYTES // max(1, (rb + m) * 5 * 32 * item))
    chunk = min(chunk, _BF16_FLUSH_WORDS)
    for w0 in range(0, W, chunk):
        w1 = min(W, w0 + chunk)
        acc4 += product(operand(a_e[:, :, w0:w1], rb), operand(b_e[:, :, w0:w1], m))
        accn += product(operand(a_n[:, w0:w1], rb), operand(b_n[:, w0:w1], m))
    return acc4 - accn, accn


def split_gram_variant(ea, nm, r0: int, rb: int, c0: int, eb=None, nmb=None, *,
                       dot: str, tile: int, unpack: str | None = None):
    """``split_gram``'s (g, gn) from a tensor-core variant of the kernel:
    ``dot`` in ("b1", "s8", "bf16") is the operand type of the ``mma``
    (``wgmma`` for b1 at tile 128, ``mma.sync`` otherwise), ``tile`` the
    block's square output tile, ``unpack`` ("shift" or "nibble", ``s8`` only)
    how a word becomes int8 values; ``SPLIT_GRAM_VARIANTS`` lists what is
    built.  Same operands, checks (the word pitch on the card included) and
    addressing as ``split_gram``.
    CPU tensors take ``split_gram_variant_reference``; CUDA tensors launch
    the variant's kernel or raise; no variant gives way to another kernel."""
    unpack = _check_variant(dot, tile, unpack)
    if ea.device.type == "cpu":
        return split_gram_variant_reference(ea, nm, r0, rb, c0, eb, nmb, dot=dot)
    eb, nmb, m = _operands(ea, nm, r0, rb, c0, eb, nmb)
    _check_cuda(ea, "split_gram_variant", max(ea.shape[0], eb.shape[0]))
    out = _launch("split_gram_mma", (ea, nm, eb, nmb), ea.shape[2], r0, rb, c0, m,
                  extra=(_VARIANT_DOT_CODES[dot, unpack], tile, _BF16_FLUSH_WORDS))
    if rb and m:
        count("kernel.launches.split_gram_mma." + variant_name(dot, tile, unpack))
    return out


# ---------------------------------------------------------------------------
# mismatch positions (the recombination filter's device step)
# ---------------------------------------------------------------------------

def _mism_operands(pa, pb, ii, jj, length, capacity, ma, mb):
    """Validated (pb, mb, ii, jj) of a mismatch-position call; ``ii`` and
    ``jj`` come back as int64 tensors on the device they came on (a numpy
    vector: the host, without a copy)."""
    if pb is None:
        pb, mb = pa, ma
    if (ma is None) != (mb is None):
        raise ValueError("ma and mb are given together or not at all")
    if ma is None:
        _check_planes(pa, "A")
        _check_planes(pb, "B")
    else:
        _check_layout(pa, ma, "A")
        _check_layout(pb, mb, "B")
    W = pa.shape[2]
    if pb.shape[2] != W:
        raise ValueError(f"A has {W} words, B has {pb.shape[2]}")
    if not 0 <= length <= 32 * W or length >= 2**31:
        raise ValueError(f"length {length} outside [0, {min(32 * W, 2**31 - 1)}]")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")
    ii = torch.as_tensor(ii, dtype=torch.int64).contiguous()
    jj = torch.as_tensor(jj, dtype=torch.int64).contiguous()
    if ii.dim() != 1 or ii.shape != jj.shape:
        raise ValueError(f"pair indices must be two vectors of one length, got "
                         f"{tuple(ii.shape)} and {tuple(jj.shape)}")
    if len({t.device for t in (pa, pb) + (() if ma is None else (ma, mb))}) != 1:
        raise ValueError("operands on several devices")
    if ii.numel() and not (0 <= int(ii.min()) and int(ii.max()) < pa.shape[0]
                           and 0 <= int(jj.min()) and int(jj.max()) < pb.shape[0]):
        raise ValueError("a pair index lies outside the layouts' rows")
    return pb, mb, ii, jj


def mismatch_positions_reference(pa, pb, ii, jj, length: int, capacity: int,
                                 ma=None, mb=None):
    """Plain exact version of ``mismatch_positions_kernel``: gathers a chunk
    of pairs, unpacks their mismatch words to one byte a site, drops the
    sites at or past ``length`` and takes ``torch.nonzero`` (row-major, so
    ascending within a pair); chunked so the unpacked sites stay under
    ~512 MB."""
    pb, mb, ii, jj = _mism_operands(pa, pb, ii, jj, length, capacity, ma, mb)
    ii, jj = ii.to(pa.device), jj.to(pa.device)
    P, W = ii.numel(), pa.shape[2]
    out = torch.full((P, 1 + capacity), -1, dtype=torch.int32, device=pa.device)
    chunk = max(1, _REFERENCE_BYTES // max(1, 2 * 32 * W))
    for s in range(0, P, chunk):
        i, j = ii[s:s + chunk], jj[s:s + chunk]
        a, b = pa[i], pb[j]
        shared = (a[:, 0] & b[:, 0]) | (a[:, 1] & b[:, 1]) | (a[:, 2] & b[:, 2]) \
            | (a[:, 3] & b[:, 3])
        if ma is not None:
            shared |= ma[i] | mb[j]
        bits = _unpack_bits(~shared)[:, :length]  # [p, length], site order
        pair, pos = torch.nonzero(bits, as_tuple=True)
        counts = torch.bincount(pair, minlength=len(i))
        out[s:s + len(i), 0] = counts.to(torch.int32)
        rank = torch.arange(len(pos), device=pa.device) - (torch.cumsum(counts, 0) - counts)[pair]
        keep = rank < capacity
        out[s + pair[keep], 1 + rank[keep]] = pos[keep].to(torch.int32)
    return out


#: pairs a tile of the tiled kernel holds at most (their state lives in its
#: shared memory; ``kMaxTilePairs`` in csrc/mism_positions.cu)
MISM_TILE_PAIRS = 512
#: distinct samples a tile holds at most (``kTileSamples``): a stage of the
#: ring holds a 128-word chunk of each, three stages deep with the N masks;
#: the main path's clusters of 21 make row-major runs that a tile covers whole
MISM_TILE_SAMPLES = 28
#: words a chunk of the tiled kernel (``kChunkWords``: 4 a lane)
MISM_CHUNK_WORDS = 128
#: parts of the word axis a tile is cut into at most (``kMaxParts``)
MISM_MAX_PARTS = 16
#: the largest capacity of the tiled kernel: a rank is 16 bits of its entries
MISM_TILED_MAX_CAPACITY = 65535
#: warps a block of the tiled kernel (``kTileWarps``)
MISM_TILE_WARPS = 32
#: entries (pair, rank, position) a block of the tiled kernel keeps at most
#: before it walks its part a second time, 512 a warp (128 KB of scratch a
#: block), and the most scratch a launch's entries take (``mism_launch_shape``)
_MISM_ENTRY_CAP = 16384
_MISM_ENTRY_BYTES = 128 << 20
#: the samples the tiled kernel's tiles may stage in all, at least, before
#: the rule hands a list to the warp kernel (``mism_design``)
MISM_TILED_MIN_SAMPLES = 1024
#: the kernels ``mismatch_positions_kernel``'s ``_design`` may name
_MISM_DESIGNS = ("tiled", "warp")


class MismTilePlan(NamedTuple):
    """The tiled kernel's cut of a pair list (``mism_tile_plan``), all int32:
    tile t holds pairs [pair_start[t], pair_start[t + 1]) and the samples
    keys[key_start[t]:key_start[t + 1]] (a row of A, or ~row of B; by side,
    then row); slots[p] is pair p's A sample's slot | its B sample's slot
    << 8; the tile's copies are boxes[box_start[t]:box_start[t + 1]], each
    its first slot | log2(rows) << 8 over rows consecutive in the layout."""

    pair_start: np.ndarray
    key_start: np.ndarray
    keys: np.ndarray
    slots: np.ndarray
    box_start: np.ndarray
    boxes: np.ndarray

    @property
    def tiles(self) -> int:
        return len(self.pair_start) - 1

    @property
    def max_samples(self) -> int:
        return int(np.diff(self.key_start).max()) if self.tiles else 0

    def words(self) -> np.ndarray:
        """The plan as the kernel reads it: one int32 vector."""
        return np.concatenate(self)


def mism_tile_plan(ii, jj, *, samples: int = MISM_TILE_SAMPLES, one_layout: bool = True,
                   stop_above: int | None = None) -> MismTilePlan | None:
    """Cuts the pair list (ii[p], jj[p]) into tiles of consecutive pairs,
    greedily in the caller's order: a tile grows while it holds at most
    ``samples`` distinct samples and ``MISM_TILE_PAIRS`` pairs (the kernel
    takes tiles of any size up to its own caps; the wrapper plans at
    ``MISM_TILE_SAMPLES``, experiments/mism_positions_probe.py --samples at
    fewer).  A sample is a row of A, or of B when
    the two sides are separate layouts (``one_layout`` False: row r of B is
    key ~r, apart from row r of A).  Gives each tile its distinct samples
    sorted by side, then row, each pair the slots of its two samples among
    them, and the tile's copies: each run of samples on consecutive rows of
    one side cut into boxes of 8, 4, 2 or 1 rows.  With ``stop_above``,
    returns None as soon as the tiles' samples add up to more than that.  A
    plain function of the indices (the pair list's order and repeats decide
    the cut, never the data), run on the host by ``csrc/mism_plan.cpp`` in
    one pass."""
    from tracs_tpu_torch.runtime.build import load_host_library

    if not 2 <= samples <= MISM_TILE_SAMPLES:
        raise ValueError(f"samples {samples} outside [2, {MISM_TILE_SAMPLES}]")
    ii = np.ascontiguousarray(ii, dtype=np.int64)
    jj = np.ascontiguousarray(jj, dtype=np.int64)
    P = len(ii)
    if len(jj) != P or (P and min(ii.min(), jj.min()) < 0):
        raise ValueError("pair indices must be two vectors of one length, none negative")
    rows = int(max(ii.max(), jj.max())) + 1 if P else 0
    fn = load_host_library("mism_plan").tracs_mism_tile_plan
    if fn.argtypes is None:
        i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        fn.restype = ctypes.c_longlong
        fn.argtypes = ([i64p, i64p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [i32p] * 6)
    pair_start, key_start, box_start = (np.empty(P + 1, dtype=np.int32) for _ in range(3))
    keys, boxes = np.empty(2 * P, dtype=np.int32), np.empty(2 * P, dtype=np.int32)
    slots = np.empty(P, dtype=np.int32)
    tiles = fn(ii, jj, P, rows, rows, samples, MISM_TILE_PAIRS, int(one_layout),
               -1 if stop_above is None else stop_above, pair_start, key_start, keys, slots,
               box_start, boxes)
    if tiles == -1:
        return None
    if tiles < 0:
        raise ValueError("the tile plan refused its inputs")
    return MismTilePlan(pair_start[:tiles + 1], key_start[:tiles + 1], keys[:key_start[tiles]],
                        slots, box_start[:tiles + 1], boxes[:box_start[tiles]])


def mism_parts(tiles: int, n_chunks: int, sms: int) -> int:
    """Parts of the word axis for ``tiles`` tiles of ``n_chunks`` chunks, one
    block a (tile, part) and one block an SM: at least two waves where the
    chunks allow, then the count that wastes the least of the last wave
    (ceil(tiles * K / sms) / K, the time in units of a whole tile; the
    fewer parts on a tie), at most ``MISM_MAX_PARTS``."""
    hi = max(1, min(MISM_MAX_PARTS, n_chunks))
    lo = min(hi, max(1, -(-2 * sms // max(1, tiles))))
    return min(range(lo, hi + 1), key=lambda k: (-(-tiles * k // sms) / k, k))


def _tiled_operands_ok(tensors, words: int, capacity: int) -> bool:
    """The tiled kernel takes the operands: a word pitch that is a multiple
    of ``LAYOUT_WORD_MULTIPLE`` and 16-byte aligned storage (the tensor maps'
    rule) and a capacity of at most ``MISM_TILED_MAX_CAPACITY``."""
    return (words % LAYOUT_WORD_MULTIPLE == 0 and capacity <= MISM_TILED_MAX_CAPACITY
            and not any(t.data_ptr() % 16 for t in tensors))


def _host_vector(x) -> np.ndarray:
    """An index vector as int64 numpy on the host (a CUDA tensor is copied)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x, dtype=np.int64)


def mism_design(tensors, words: int, ii, jj, capacity: int, one_layout: bool,
                design: str | None = None):
    """(kernel, plan): the kernel ``mismatch_positions_kernel`` launches on
    the card for these inputs, "tiled" with its tile plan or "warp" with
    None.  The rule: the tiled kernel where it takes the operands
    (``_tiled_operands_ok``) and its tiles stage at most
    max(``MISM_TILED_MIN_SAMPLES``, P) samples in all; otherwise the warp
    kernel.  Measured in turns at the main path's W = 31,252 on an H100
    (experiments/mism_positions_probe.py --patterns): the tiled kernel's time
    follows the samples it stages (~2,000-4,500 a ms), the warp kernel's the
    pairs (~3,300-5,700 a ms, re-reads served by L2) above a floor of ~0.53
    ms (a warp walks a pair's words alone), in which the tiled kernel stages
    ~1,000 samples.  The tiled kernel was faster on clustered row-major
    blocks (0.13-0.19 samples a pair), on every sample against itself (1.0 a
    pair, 1.35x) and on every list of at most ~660 staged samples (one pair
    to 600 pairs, 2.7-9x); the warp kernel on 10,280 pairs in no order (2.0
    a pair, 2.9x) and on whole rows against every later sample (1.04 a pair,
    2.1x; pairs that mismatch at most sites).  The cut at one sample a pair
    lies between those readings.  ``design`` forces one; forced, the tiled
    kernel raises on operands it does not take.  The rule reads the inputs
    only: a build or launch error raises and never chooses.  The indices go
    to the host (for the plan) only where the operands let the tiled kernel
    run."""
    if design not in (None, *_MISM_DESIGNS):
        raise ValueError(f"unknown design {design!r}")
    if design == "warp":
        return "warp", None
    ok = _tiled_operands_ok(tensors, words, capacity)
    if design == "tiled" and not ok:
        raise ValueError(
            f"the tiled mismatch-position kernel needs a word pitch that is a multiple of "
            f"{LAYOUT_WORD_MULTIPLE}, 16-byte aligned storage and a capacity of at most "
            f"{MISM_TILED_MAX_CAPACITY}; got {words} words, capacity {capacity}")
    if not ok:
        return "warp", None
    ii, jj = _host_vector(ii), _host_vector(jj)
    limit = max(MISM_TILED_MIN_SAMPLES, len(ii))
    plan = mism_tile_plan(ii, jj, one_layout=one_layout,
                          stop_above=None if design == "tiled" else limit)
    return ("warp", None) if plan is None else ("tiled", plan)


class MismLaunchShape(NamedTuple):
    """How the tiled kernel walks the word axis for a plan (``mism_launch_shape``)."""

    n_chunks: int      # chunks of MISM_CHUNK_WORDS that hold a site below the length
    parts: int         # parts of the word axis, none of them empty
    part_chunks: int   # chunks a part
    entry_cap: int     # entries a block keeps before it walks its part again


def mism_launch_shape(plan: MismTilePlan, length: int, sms: int,
                      capacity: int) -> MismLaunchShape:
    """The tiled kernel's chunks and parts for ``plan`` at ``length`` sites on
    a card of ``sms`` SMs: the chunks cover the words that hold a site,
    ceil(length / 32), and ``mism_parts`` cuts them.  A block keeps at most
    ``_MISM_ENTRY_CAP`` entries, no more than its largest tile can use (a
    rank below the capacity for each of its pairs), and the launch's entries
    at most ``_MISM_ENTRY_BYTES``; a whole number a warp, at least one.  A
    block with more mismatches walks its part again."""
    n_chunks = -(-(-(-length // 32)) // MISM_CHUNK_WORDS)
    parts = mism_parts(plan.tiles, n_chunks, sms)
    part_chunks = -(-n_chunks // parts) if n_chunks else 0
    parts = -(-n_chunks // part_chunks) if n_chunks else 1
    pairs = int(np.diff(plan.pair_start).max()) if plan.tiles else 0
    entries = min(_MISM_ENTRY_CAP, pairs * capacity,
                  _MISM_ENTRY_BYTES // (8 * max(1, plan.tiles * parts)))
    entries = max(MISM_TILE_WARPS, entries // MISM_TILE_WARPS * MISM_TILE_WARPS)
    return MismLaunchShape(n_chunks, parts, part_chunks, entries)


def _mism_warp_launcher(pa, pb, ma, mb, ii, jj, length, capacity, out):
    fn = _kernel_entry("mism_positions", (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2
    ), "mism_positions_warp")
    ii, jj = ii.to(pa.device), jj.to(pa.device)
    args = (pa.data_ptr(), None if ma is None else ma.data_ptr(),
            pb.data_ptr(), None if mb is None else mb.data_ptr(),
            ii.data_ptr(), jj.data_ptr(), len(ii), pa.shape[2], length, capacity, out.data_ptr())

    def launch():
        return fn(*args, torch.cuda.current_stream(pa.device).cuda_stream)
    launch.buffers = (ii, jj)   # alive while the launcher lives
    return launch


#: ctypes argument types of ``tracs_mism_positions_tiled``
_MISM_TILED_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)


def _mism_tiled_launcher(pa, pb, ma, mb, plan: MismTilePlan, length, capacity, out, fn=None):
    """The tiled kernel's launcher; ``fn`` replaces the built entry point by
    another library's (experiments/mism_positions_probe.py times rewritten
    copies of the source through it)."""
    dev = pa.device
    shape = mism_launch_shape(plan, length,
                              torch.cuda.get_device_properties(dev).multi_processor_count,
                              capacity)
    P = len(plan.slots)
    scratch_words = _kernel_entry(
        "mism_positions", [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
        "mism_positions_scratch_words", ctypes.c_longlong)(plan.tiles, shape.parts, P,
                                                           shape.entry_cap)
    scratch = torch.empty(scratch_words, dtype=torch.int32, device=dev)
    plan_dev = torch.from_numpy(plan.words()).to(dev)
    if fn is None:
        fn = _kernel_entry("mism_positions", _MISM_TILED_ARGTYPES, "mism_positions_tiled")
    args = (pa.data_ptr(), None if ma is None else ma.data_ptr(),
            pb.data_ptr(), None if mb is None else mb.data_ptr(),
            pa.shape[0], pb.shape[0], pa.shape[2], length, capacity,
            plan_dev.data_ptr(), plan.tiles, len(plan.keys), P, plan.max_samples,
            shape.parts, shape.part_chunks, shape.n_chunks, shape.entry_cap,
            scratch.data_ptr(), out.data_ptr())

    def launch():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    launch.buffers = (scratch, plan_dev)   # alive while the launcher lives
    return launch


def _mism_launcher(pa, pb, ii, jj, length: int, capacity: int, ma=None, mb=None,
                   design: str | None = None):
    """(out, design, launch) of a mismatch-position call on the card: the
    operands validated, the kernel chosen by ``mism_design`` (``design``
    forces one), the output, the plan and the scratch allocated; ``launch()``
    launches the kernel on the current stream and returns the entry point's
    CUDA error (0: none).  Calling it again relaunches on the same buffers
    (timing, through ``chip_smoke.device_ms``); it counts no launch."""
    pb, mb, ii, jj = _mism_operands(pa, pb, ii, jj, length, capacity, ma, mb)
    _check_cuda(pa, "mismatch_positions_kernel", max(pa.shape[0], pb.shape[0]))
    out = torch.empty((ii.numel(), 1 + capacity), dtype=torch.int32, device=pa.device)
    if ii.numel() == 0:
        return out, None, None
    tensors = (pa, pb) + (() if ma is None else (ma, mb))
    design, plan = mism_design(tensors, pa.shape[2], ii, jj, capacity, pb is pa and mb is ma,
                               design)
    with torch.cuda.device(pa.device):
        if design == "tiled":
            launch = _mism_tiled_launcher(pa, pb, ma, mb, plan, length, capacity, out)
        else:
            launch = _mism_warp_launcher(pa, pb, ma, mb, ii, jj, length, capacity, out)
    return out, design, launch


def mismatch_positions_kernel(pa, pb, ii, jj, length: int, capacity: int,
                              ma=None, mb=None, *, _design: str | None = None):
    """int32 [P, 1 + capacity]: for pair p = (row ii[p] of A, row jj[p] of B)
    the number of sites below ``length`` where the two samples share no
    allele, then the first ``capacity`` such sites in ascending order, then
    -1 (counterpart of tracs_tpu.ops.pairsnp._mism_positions_kernel, which
    leaves the entries past the count unspecified).

    pa, pb : int32 [n, 4, W] planes; ``pb`` None means ``pa`` (and ``ma``).
    Without masks they are raw planes and a site is shared when
    OR_x(a_x & b_x) is set.  With ``ma``/``mb`` (int32 [n, W] N masks) they
    are the split layout's N-exclusive planes and
    shared = OR_x(ea_x & eb_x) | na | nb.  The full resident layouts and the
    pair indices (numpy or tensors, on the host or the card) go in; no
    gathered copy is made.  CPU tensors take ``mismatch_positions_reference``;
    CUDA tensors launch one of the two kernels of ``csrc/mism_positions.cu``
    once, by ``mism_design``'s rule on the inputs, or raise: the tiled kernel
    (tiles of pairs that stage their samples' rows once, the word axis cut
    into parts), counted in ``kernel.launches.mism_positions_tiled``, or the
    warp kernel (a warp a pair); ``kernel.launches.mism_positions`` counts
    both.
    ``_design`` ("tiled" or "warp") forces one kernel, for the card-only
    tests and the experiments that hold the two side by side."""
    if pa.device.type == "cpu":
        return mismatch_positions_reference(pa, pb, ii, jj, length, capacity, ma, mb)
    out, design, launch = _mism_launcher(pa, pb, ii, jj, length, capacity, ma, mb, _design)
    if launch is None:
        return out
    with torch.cuda.device(pa.device):
        rc = launch()
    if rc != 0:
        raise RuntimeError(f"mism_positions {design} kernel launch failed: CUDA error {rc}")
    count("kernel.launches.mism_positions")
    if design == "tiled":
        count("kernel.launches.mism_positions_tiled")
    return out


# ---------------------------------------------------------------------------
# the partial-IUPAC correction gram (the split engine's third gram)
# ---------------------------------------------------------------------------

#: partial-correction channels: AND-products over plane pairs (sign -1) and
#: plane triples (sign +1); the quad is structurally zero on exclusive planes
_PAIR_SUBSETS = [s for s in _SUBSETS if bin(s).count("1") == 2]
_TRIPLE_SUBSETS = [s for s in _SUBSETS if bin(s).count("1") == 3]
_PARTIAL_SIGNS = [-1.0] * 6 + [1.0] * 4

#: ``partial_gram``'s kernel sums 6 plane-pair grams of 32 sites a word in
#: one int32 accumulator: 192 * Wp stays below 2^31 for Wp below this
_PARTIAL_GRAM_MAX_WORDS = 2**23
#: rows of A the kernel's grid holds: 65535 tiles of 128 rows
_PARTIAL_GRAM_MAX_ROWS = 65535 * 128
#: parts into which ``partial_gram``'s kernel cuts the word axis; 0: the
#: launcher chooses, as for ``popcount_gram``
_PARTIAL_GRAM_WORD_SPLITS = 0


def _partial_operands(part_a, part_b) -> None:
    """Raises unless (part_a, part_b) are [n, 4, Wp] int32 planes of one word
    count on one device."""
    _check_planes(part_a, "part_a")
    _check_planes(part_b, "part_b")
    if part_a.shape[2] != part_b.shape[2]:
        raise ValueError(f"part_a has {part_a.shape[2]} words, part_b has {part_b.shape[2]}")
    if part_a.device != part_b.device:
        raise ValueError(f"operands on several devices: {part_a.device}, {part_b.device}")


def partial_gram_reference(part_a, part_b):
    """Plain exact version of ``partial_gram``: the 10 pair and triple
    AND-channels of each operand unpacked to 0/1 and contracted in float64
    (exact: every sum is an integer far below 2^53; int8 ``torch.mm`` would
    wrap and CUDA has no int32 ``mm``), the triples' grams added and the
    pairs' subtracted, chunked over words so the unpacked operands stay under
    ~512 MB."""
    _partial_operands(part_a, part_b)
    na, nb = part_a.shape[0], part_b.shape[0]
    f64 = dict(dtype=torch.float64, device=part_a.device)
    acc = torch.zeros((na, nb), **f64)
    if na == 0 or nb == 0:
        return acc.to(torch.int32)
    channels = [s - 1 for s in _PAIR_SUBSETS + _TRIPLE_SUBSETS]
    ca, cb = _subset_products(part_a)[:, channels], _subset_products(part_b)[:, channels]
    Wp = ca.shape[2]
    signs = torch.tensor(_PARTIAL_SIGNS, **f64)[None, :, None]
    chunk = max(1, _REFERENCE_BYTES // max(1, (na + nb) * 10 * 32 * 8))
    for w0 in range(0, Wp, chunk):
        w1 = min(Wp, w0 + chunk)
        xa = _unpack_bits(ca[:, :, w0:w1]).to(torch.float64).reshape(na, -1)
        xb = (_unpack_bits(cb[:, :, w0:w1]).to(torch.float64) * signs).reshape(nb, -1)
        acc += xa @ xb.T
        del xa, xb
    return acc.to(torch.int32)


def partial_gram(part_a, part_b):
    """The split decomposition's correction gram, int32 [na, nb]:
    ``sum_{|S|=3} G_S - sum_{|S|=2} G_S`` over the plane pairs and triples
    S, G_S[i, j] the popcount of the AND over S of sample i's words and of
    sample j's, which ADDS to the match count (counterpart of
    tracs_tpu.ops.pairsnp._gram_partial).

    part_a, part_b : int32 [n, 4, Wp] exclusive planes gathered at the
    partial-IUPAC sites (the split layout's ``partial``, or rows of it).
    CPU tensors take ``partial_gram_reference``; CUDA tensors launch the
    kernel ``csrc/partial_gram.cu`` or raise: their word pitch must be a
    multiple of ``LAYOUT_WORD_MULTIPLE`` and their storage 16-byte aligned
    (``pad_planes`` pads; a zero word adds nothing to any gram), and ``Wp``
    below ``_PARTIAL_GRAM_MAX_WORDS``, the range of the kernel's int32 sums."""
    if part_a.device.type == "cpu":
        return partial_gram_reference(part_a, part_b)
    _partial_operands(part_a, part_b)
    na, nb, Wp = part_a.shape[0], part_b.shape[0], part_a.shape[2]
    if Wp >= _PARTIAL_GRAM_MAX_WORDS or na > _PARTIAL_GRAM_MAX_ROWS:
        raise ValueError(f"partial_gram: {na} rows of {Wp} words; the kernel takes at most "
                         f"{_PARTIAL_GRAM_MAX_ROWS} rows and fewer than "
                         f"{_PARTIAL_GRAM_MAX_WORDS} words (its int32 sums)")
    _check_cuda(part_a, "partial_gram", max(na, nb))
    _check_pitch((part_a,), Wp, "part_a", "pad_planes(p)")
    _check_pitch((part_b,), Wp, "part_b", "pad_planes(p)")
    out = torch.empty((na, nb), dtype=torch.int32, device=part_a.device)
    if na == 0 or nb == 0:
        return out
    if Wp == 0:
        return out.zero_()
    fn = _kernel_entry("partial_gram", [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    with torch.cuda.device(part_a.device):
        stream = torch.cuda.current_stream(part_a.device).cuda_stream
        rc = fn(part_a.data_ptr(), part_b.data_ptr(), na, nb, Wp, _PARTIAL_GRAM_WORD_SPLITS,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"partial_gram kernel launch failed: CUDA error {rc}")
    count("kernel.launches.partial_gram")
    return out


# ---------------------------------------------------------------------------
# the block's D/NN assembly, threshold and row-major COO compaction
# ---------------------------------------------------------------------------

#: the modes of ``coo_extract``: how D and NN come from the grams
COO_MODES = ("split", "direct")

def clamp_threshold(dist: int) -> int:
    """``dist`` clamped to [-1, 2^31 - 1], the int32 value D is compared with
    (D is never negative, so every threshold below 0 keeps nothing)."""
    return max(-1, min(int(dist), 2**31 - 1))


def _coo_operands(g, gn, mode, L, r0, c0, n_valid, gp, cnt_a, cnt_b) -> None:
    """Raises unless the arguments are a valid ``coo_extract`` call."""
    if mode not in COO_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {COO_MODES}")
    blocks = [g, gn] + ([] if gp is None else [gp])
    for name, t in zip(("g", "gn", "gp"), blocks):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name}: want an int32 [rb, m] block, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.shape != g.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, g is {tuple(g.shape)}")
    rb, m = g.shape
    if mode == "split":
        if cnt_a is None or cnt_b is None:
            raise ValueError("split mode needs cnt_a and cnt_b")
        for name, t, n in (("cnt_a", cnt_a, rb), ("cnt_b", cnt_b, m)):
            if t.dtype != torch.int32 or tuple(t.shape) != (n,):
                raise ValueError(f"{name}: want int32 [{n}], got {t.dtype} {tuple(t.shape)}")
        blocks += [cnt_a, cnt_b]
    elif gp is not None or cnt_a is not None or cnt_b is not None:
        raise ValueError("direct mode takes no gp, cnt_a or cnt_b")
    if not all(t.is_contiguous() for t in blocks):
        raise ValueError("coo_extract: tensors must be contiguous")
    if len({t.device for t in blocks}) != 1:
        raise ValueError("coo_extract: operands on several devices")
    if not 0 <= L < 2**31:
        raise ValueError(f"length {L} outside [0, 2^31)")
    if min(r0, c0, n_valid) < 0:
        raise ValueError(f"r0 {r0}, c0 {c0} and n_valid {n_valid} must be >= 0")
    if max(rb, m) >= 2**31:
        raise ValueError("a block dimension beyond the output's int32 indices")


def coo_extract_reference(g, gn, *, mode: str, L: int, dist: int, r0: int, c0: int,
                          n_valid: int, triangle: bool, gp=None, cnt_a=None, cnt_b=None):
    """Plain version of ``coo_extract`` (the port's route before the kernel):
    D and NN assembled as whole int32 blocks, the three masks, ``torch.nonzero``
    (row-major) and four gathers."""
    _coo_operands(g, gn, mode, L, r0, c0, n_valid, gp, cnt_a, cnt_b)
    rb, m = g.shape
    if mode == "split":
        match = g + cnt_a[:, None] + cnt_b[None, :]
        if gp is not None:
            match = match + gp
        D = L - match
        NN = L - cnt_a[:, None] - cnt_b[None, :] + gn
    else:
        D, NN = L - g, L - gn
    cols = torch.arange(m, device=g.device, dtype=torch.int64) + c0
    mask = (D <= clamp_threshold(dist)) & (cols < n_valid)[None, :]
    if triangle:
        rows = torch.arange(rb, device=g.device, dtype=torch.int64) + r0
        mask &= cols[None, :] > rows[:, None]
    i, j = torch.nonzero(mask).unbind(1)  # row-major
    return torch.stack([i.to(torch.int32), j.to(torch.int32), D[i, j], NN[i, j]])


def coo_capacity(rb: int, m: int, r0: int, c0: int, n_valid: int, triangle: bool) -> int:
    """The most pairs ``coo_extract`` can keep from an rb x m block of rows
    [r0, r0 + rb) against global columns [c0, c0 + m): those whose global
    column is below ``n_valid`` and, with ``triangle``, above the row.  Every
    one of them survives at a threshold of 2^31 - 1.  Plain arithmetic on the
    geometry: local row i keeps local columns [max(0, r0 + i - c0 + 1), hi)
    on a triangle block, [0, hi) otherwise, with hi = min(m, n_valid - c0)."""
    hi = min(m, max(0, n_valid - c0))
    if rb <= 0 or hi == 0:
        return 0
    if not triangle:
        return rb * hi
    d = r0 - c0 + 1              # row i starts at column max(0, d + i)
    whole = min(rb, max(0, 1 - d))   # rows with d + i <= 0 keep all hi columns
    end = min(rb, max(whole, hi - d))  # rows below it with d + i < hi keep hi - d - i
    k = end - whole
    return whole * hi + k * (hi - d) - k * (whole + end - 1) // 2


def _coo_launch(g, gn, mode, L, dist, r0, c0, n_valid, triangle, gp, cnt_a, cnt_b):
    """``coo_extract``'s one launch on the current stream of the grams' card,
    validated and counted: (out int32 [capacity, 4], the kernel's scratch,
    whose word 1 holds the number of survivors k once the launch has run).
    Nothing here waits for the card."""
    _coo_operands(g, gn, mode, L, r0, c0, n_valid, gp, cnt_a, cnt_b)
    rb, m = g.shape
    _check_cuda(g, "coo_extract", rb)
    dev = g.device
    out = torch.empty((coo_capacity(rb, m, r0, c0, n_valid, triangle), 4), dtype=torch.int32,
                      device=dev)
    # the ticket counter, the total and the scan's status words, at the
    # length the kernel's library gives; zeroed by the entry point
    words = _kernel_entry("coo_extract", [ctypes.c_longlong] * 2, "coo_extract_scratch_words",
                          ctypes.c_longlong)(rb, m)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    fn = _kernel_entry("coo_extract", (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = fn(g.data_ptr(), gn.data_ptr(), ptr(gp), ptr(cnt_a), ptr(cnt_b), rb, m, L,
                clamp_threshold(dist), r0 - c0, int(bool(triangle)),
                min(m, max(0, n_valid - c0)), int(mode == "split"), scratch.data_ptr(), words,
                ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coo_extract kernel launch failed: CUDA error {rc}")
    if words > 2:  # a block with a tile: the kernel was launched
        count("kernel.launches.coo_extract")
    return out, scratch


def coo_extract(g, gn, *, mode: str, L: int, dist: int, r0: int, c0: int, n_valid: int,
                triangle: bool, gp=None, cnt_a=None, cnt_b=None):
    """Survivors of one block of the all-pairs sweep, int32 [4, k] =
    (local row, local column, d, nn), in row-major order (tracs_tpu's
    emission order; counterpart of tracs_tpu.ops.pairsnp._extract_coo_packed
    with the block assembly before it).

    g, gn : the engine's int32 [rb, m] gram blocks of rows [r0, r0 + rb)
    against global columns [c0, c0 + m).  ``mode``:

    * ``split``: D = L - (g + gp + cnt_a + cnt_b), NN = L - cnt_a - cnt_b + gn
      (``gp`` the correction gram or None; ``cnt_a`` [rb], ``cnt_b`` [m] the
      samples' N counts);
    * ``direct``: D = L - g, NN = L - gn (g = matches, gn = nunion).

    A pair survives when d <= ``clamp_threshold(dist)``, its global column is
    below ``n_valid`` and, with ``triangle``, above its global row.  CPU
    tensors take ``coo_extract_reference``; CUDA tensors launch the kernel
    ``csrc/coo_extract.cu`` once or raise.  The output is sized on the host
    by ``coo_capacity`` as [capacity, 4] rows; the kernel counts, scans and
    emits, so the k survivors are its first k rows, and the only wait is for
    k, copied to a pinned host word after the launch.  On the card the result
    is the [4, k] transpose of those rows: ``coo.T`` is one contiguous piece
    of k x 16 bytes (it keeps the capacity's storage alive while it lives).
    No D or NN block is made."""
    return coo_extract_launch(g, gn, mode=mode, L=L, dist=dist, r0=r0, c0=c0,
                              n_valid=n_valid, triangle=triangle, gp=gp, cnt_a=cnt_a,
                              cnt_b=cnt_b).wait()


#: per card, the stream that ``PendingCoo.host`` copies survivors on
_COPY_STREAMS: dict[int, torch.cuda.Stream] = {}


class PendingCoo:
    """A launched ``coo_extract``: the kernel and the copy of its total k to
    a pinned host word are queued, and an event marks their end.  ``wait()``
    and ``host()`` wait for that event alone, so kernels queued on the stream
    after the launch (the next row block's grams) keep the card busy while
    the host takes these survivors.  On the CPU the result is already there."""

    def __init__(self, out: torch.Tensor, k: torch.Tensor | None = None,
                 done: torch.cuda.Event | None = None):
        self._out, self._k, self._done = out, k, done

    def wait(self) -> torch.Tensor:
        """``coo_extract``'s int32 [4, k] result."""
        if self._done is None:
            return self._out
        self._done.synchronize()
        return self._out[:int(self._k)].T

    def host(self) -> np.ndarray:
        """The survivors as an int32 numpy [k, 4] (``wait()`` transposed),
        copied to pinned memory on a side stream of the card that waits for
        this launch only."""
        rows = self.wait().T
        if self._done is None:
            return to_host(rows)
        dev = rows.device
        stream = _COPY_STREAMS.get(dev.index)
        if stream is None:
            stream = _COPY_STREAMS[dev.index] = torch.cuda.Stream(dev)
        stream.wait_event(self._done)
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(rows, non_blocking=True)
        stream.synchronize()
        return host.numpy()


def coo_extract_launch(g, gn, *, mode: str, L: int, dist: int, r0: int, c0: int,
                       n_valid: int, triangle: bool, gp=None, cnt_a=None,
                       cnt_b=None) -> PendingCoo:
    """``coo_extract`` without its wait: the same arguments and checks, and
    the result as a ``PendingCoo``."""
    if g.device.type == "cpu":
        return PendingCoo(coo_extract_reference(
            g, gn, mode=mode, L=L, dist=dist, r0=r0, c0=c0, n_valid=n_valid,
            triangle=triangle, gp=gp, cnt_a=cnt_a, cnt_b=cnt_b))
    out, scratch = _coo_launch(g, gn, mode, L, dist, r0, c0, n_valid, triangle, gp, cnt_a,
                               cnt_b)
    # the one wait of the call is for the total, copied after the launch
    k = torch.empty(1, dtype=torch.int64, pin_memory=True)
    k.copy_(scratch[1:2], non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(g.device))
    return PendingCoo(out, k, done)


# ---------------------------------------------------------------------------
# the split layout, built on the card
# ---------------------------------------------------------------------------

def _popcount(words: torch.Tensor) -> torch.Tensor:
    """int64 popcount of each int32 word's 32 bits (SWAR arithmetic on int64,
    where the words' high bit is no sign)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def split_layout_reference(planes):
    """Plain exact version of ``split_layout``: the layout's planes by
    elementwise ops, padded by ``pad_layout``, the N counts by ``_popcount``
    and the partial OR by a tree of ORs over the samples."""
    _check_planes(planes, "planes")
    a, c, g, t = planes.unbind(1)
    all4 = a & c & g & t
    ge2 = (a & c) | (a & g) | (a & t) | (c & g) | (c & t) | (g & t)
    excl, nmask = pad_layout(planes & ~all4[:, None, :], all4)
    cnt_n = _popcount(all4).sum(dim=-1).to(torch.int32)
    part = ge2 & ~all4
    while part.shape[0] > 1:
        half = part.shape[0] // 2
        part = torch.cat([part[:half] | part[half:2 * half], part[2 * half:]])
    partial_or = part[0] if part.shape[0] else part.new_zeros(part.shape[1])
    return excl, nmask, cnt_n, partial_or


def split_layout(planes):
    """The split layout of raw planes, on their device:
    ``(excl, nmask, cnt_n, partial_or)`` with excl = planes & ~all4 int32
    [n, 4, padded_words(W)] and nmask = all4 = A & C & G & T int32
    [n, padded_words(W)] (the pad words zero: the card's pitch, as
    ``pad_layout`` gives it), cnt_n int32 [n] the popcount of each sample's
    all4, and partial_or int32 [W] the OR over the samples of the sites that
    hold a 2- or 3-bit code (two or more planes set, not all four).
    tracs_tpu's host pass ``tracs_tpu/ops/packing.py::split_alignment``
    gives the same words.

    planes : int32 [n, 4, W], contiguous, at their natural width W.  CPU
    tensors take ``split_layout_reference``; CUDA tensors launch the kernel
    ``csrc/split_layout.cu`` once (one pass over the words) or raise."""
    if planes.device.type == "cpu":
        return split_layout_reference(planes)
    _check_planes(planes, "planes")
    n, W = planes.shape[0], planes.shape[2]
    _check_cuda(planes, "split_layout", n)
    pitch = padded_words(W)
    dev = planes.device
    excl = torch.empty((n, 4, pitch), dtype=torch.int32, device=dev)
    nmask = torch.empty((n, pitch), dtype=torch.int32, device=dev)
    cnt_n = torch.empty(n, dtype=torch.int32, device=dev)
    partial_or = torch.empty(W, dtype=torch.int32, device=dev)
    if n == 0 or W == 0:
        return excl, nmask, cnt_n.zero_(), partial_or.zero_()
    fn = _kernel_entry("split_layout", [ctypes.c_void_p] + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p] * 5)
    with torch.cuda.device(dev):
        rc = fn(planes.data_ptr(), n, W, pitch, excl.data_ptr(), nmask.data_ptr(),
                cnt_n.data_ptr(), partial_or.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_layout kernel launch failed: CUDA error {rc}")
    count("kernel.launches.split_layout")
    return excl, nmask, cnt_n, partial_or


def _gather_operands(excl, positions) -> torch.Tensor:
    """``positions`` as an int64 tensor on ``excl``'s device; raises unless
    (excl, positions) are a valid ``split_gather`` call."""
    _check_planes(excl, "excl")
    positions = np.asarray(positions)
    if positions.ndim != 1 or (positions.size and positions.dtype.kind not in "iu"):
        raise TypeError(f"positions: want integers [P], got {positions.dtype} {positions.shape}")
    if positions.size and not (0 <= positions.min() and positions.max() < 32 * excl.shape[2]):
        raise ValueError(f"positions outside the {32 * excl.shape[2]} sites of excl")
    return torch.from_numpy(positions.astype(np.int64)).to(excl.device)


def split_gather_reference(excl, positions):
    """Plain exact version of ``split_gather``: the bits picked by indexing
    and shifts, packed by a weighted sum in int64."""
    positions = _gather_operands(excl, positions)
    n, P = excl.shape[0], positions.numel()
    pitch = padded_words(max(1, -(-P // 32)))
    bits = torch.zeros((n, 4, pitch * 32), dtype=torch.int64, device=excl.device)
    if P:
        bits[:, :, :P] = (excl[:, :, positions >> 5] >> (positions & 31).to(torch.int32)) & 1
    weights = torch.ones(32, dtype=torch.int64, device=excl.device) << torch.arange(
        32, device=excl.device)
    words = (bits.view(n, 4, pitch, 32) * weights).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def split_gather(excl, positions):
    """The split layout's partial planes: the bits of the exclusive planes
    ``excl`` (int32 [n, 4, W'], any pitch) at the sites ``positions`` (host
    integers [P], each below 32 W'; they cross to the card), packed 32 a word in the order given, int32
    [n, 4, padded_words(max(1, ceil(P / 32)))] with the words past the
    last site zero: tracs_tpu's ``partial`` at the card's pitch, as
    ``pad_planes`` gives it.  CPU tensors take ``split_gather_reference``;
    CUDA tensors launch the second kernel of ``csrc/split_layout.cu`` (a warp
    an output word) or raise."""
    if excl.device.type == "cpu":
        return split_gather_reference(excl, positions)
    positions = _gather_operands(excl, positions)
    n, P = excl.shape[0], positions.numel()
    pitch = padded_words(max(1, -(-P // 32)))
    _check_cuda(excl, "split_gather", n)
    out = torch.empty((n, 4, pitch), dtype=torch.int32, device=excl.device)
    if n == 0:
        return out
    fn = _kernel_entry("split_layout", [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2,
                       "split_gather")
    with torch.cuda.device(excl.device):
        rc = fn(excl.data_ptr(), 4 * n, excl.shape[2], positions.data_ptr(), P, pitch,
                out.data_ptr(), torch.cuda.current_stream(excl.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_gather kernel launch failed: CUDA error {rc}")
    count("kernel.launches.split_gather")
    return out


# ---------------------------------------------------------------------------
# the transmission model's k loop
# ---------------------------------------------------------------------------

def check_k_lanes(tensors) -> None:
    """Raise unless ``tensors`` are k-loop lanes as ``trans_k_loop`` and
    its plain version take them: float64, contiguous, one-dimensional, of
    one length and on one device."""
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.float64:
            raise TypeError(f"the k loop's lanes are float64, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"the k loop's lanes lie on {first.device} and {t.device}")
        if t.dim() != 1 or t.shape != first.shape:
            raise ValueError(f"the k loop's lanes are one [m] vector each, got "
                             f"{tuple(first.shape)} and {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("the k loop's lanes must be contiguous")


def trans_k_loop(lane, log_I0, lg_N2, *, lamb: float, beta: float, threshold_Ek: float,
                 k_cap: int):
    """(E(K), exit k) of the k loop's lanes, float64 [m] tensors on their
    card: ``lane`` = (N, delta, log delta, log_pois, upper bound,
    lgamma(N+1)), ``log_I0`` their seeded log I(N) and ``lg_N2``
    lgamma(N+2), each float64 [m] on one CUDA device, best sorted by
    (delta, N).  One launch of ``csrc/trans_k_loop.cu``, each lane run to
    its own exit or to ``k_cap``; raises if the launch is refused or the
    lanes are not CUDA tensors (``check_k_lanes``)."""
    tensors = (*lane, log_I0, lg_N2)
    check_k_lanes(tensors)
    dev = lane[0].device
    if dev.type != "cuda":
        raise ValueError(f"trans_k_loop's kernel runs on cuda, not {dev}")
    eK = torch.empty_like(lane[0])
    k_end = torch.empty_like(lane[0])
    if eK.numel() == 0:
        return eK, k_end
    fn = _kernel_entry("trans_k_loop", [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_double] * 7 + [ctypes.c_void_p] * 3)
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in tensors), eK.shape[0], math.log(lamb),
                math.log(beta), math.log(lamb + beta), lamb + beta, beta, threshold_Ek,
                float(k_cap), eK.data_ptr(), k_end.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trans_k_loop kernel launch failed: CUDA error {rc}")
    count("kernel.launches.trans_k_loop")
    return eK, k_end
