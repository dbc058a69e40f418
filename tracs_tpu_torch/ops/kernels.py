"""Hand-written device kernels of the port and their plain PyTorch versions
(counterpart of tracs_tpu/ops/pallas_kernels.py).

``split_gram`` — the split-decomposition grams of a row block against a
column suffix, ``g = G4 - Gn`` and ``gn = Gn`` (see ops/pairsnp.py).  On a
CUDA tensor it launches the CUDA kernel ``csrc/split_gram.cu`` (built for
sm_90a at first use, runtime/build.py) and counts the launch in
``SPLIT_GRAM_LAUNCHES``; on a CPU tensor it returns
``split_gram_reference``, the plain exact version.  There is no fallback
from one to the other.

Layouts: packed words are ``int32`` tensors holding the bits of the uint32
planes; the kernel reads them as ``uint32``.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of the CUDA split-gram kernel in this process
SPLIT_GRAM_LAUNCHES = 0

# words per chunk of the plain version: bounds the unpacked float64 operands
_REFERENCE_BYTES = 512 << 20


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 packed words -> [..., W*32] uint8 0/1 bits.

    Shifts a uint8 view of the words: torch has no ``>>`` for uint32 on the
    CPU.  Bits come out in byte-major order, the same permutation of the
    sites for every operand, which a contraction over sites cannot see."""
    b = words.contiguous().view(torch.uint8)  # [..., W*4]
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((b.unsqueeze(-1) >> shifts) & 1).reshape(*words.shape[:-1], -1)


def _check_layout(e: torch.Tensor, nm: torch.Tensor, what: str) -> None:
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


def _operands(ea, nm, r0, rb, c0, eb, nmb):
    """Validated (eb, nmb, m) for a split-gram call."""
    if (eb is None) != (nmb is None):
        raise ValueError("eb and nmb are given together or not at all")
    if eb is None:
        eb, nmb = ea, nm
    _check_layout(ea, nm, "A")
    _check_layout(eb, nmb, "B")
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


def _split_gram_entry():
    """The kernel library's C entry point, built and typed on first use."""
    from tracs_tpu_torch.runtime.build import load_cuda_library

    fn = load_cuda_library("split_gram").tracs_split_gram
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 3
        )
    return fn


def split_gram(ea, nm, r0: int, rb: int, c0: int, eb=None, nmb=None):
    """Split-decomposition grams (g, gn), int32 [rb, n_b - c0], of rows
    [r0, r0+rb) of the A layout against rows [c0, n_b) of the B layout.

    ea, eb : int32 [n, 4, W] N-exclusive planes; nm, nmb : int32 [n, W] N
    masks.  ``eb``/``nmb`` default to ``ea``/``nm`` (the self all-pairs
    sweep); they are given for a query-vs-db rectangle.  The full
    device-resident layouts go in; no block is copied.  CPU tensors take
    ``split_gram_reference``; CUDA tensors launch the kernel or raise."""
    global SPLIT_GRAM_LAUNCHES
    if ea.device.type == "cpu":
        return split_gram_reference(ea, nm, r0, rb, c0, eb, nmb)
    if ea.device.type != "cuda":
        raise ValueError(f"split_gram runs on cuda or cpu, not {ea.device}")
    eb, nmb, m = _operands(ea, nm, r0, rb, c0, eb, nmb)
    if max(ea.shape[0], eb.shape[0]) >= 2**31:
        raise ValueError("more rows than the kernel's int32 row indexing holds")
    fn = _split_gram_entry()
    g = torch.empty((rb, m), dtype=torch.int32, device=ea.device)
    gn = torch.empty((rb, m), dtype=torch.int32, device=ea.device)
    if rb == 0 or m == 0:
        return g, gn
    with torch.cuda.device(ea.device):
        stream = torch.cuda.current_stream(ea.device).cuda_stream
        rc = fn(ea.data_ptr(), nm.data_ptr(), eb.data_ptr(), nmb.data_ptr(),
                ea.shape[2], r0, rb, c0, m, g.data_ptr(), gn.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"split_gram kernel launch failed: CUDA error {rc}")
    SPLIT_GRAM_LAUNCHES += 1
    return g, gn
