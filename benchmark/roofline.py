"""The card's peaks and the least time of the all-pairs sweep (the arithmetic
of ``chip_smoke.py::bound`` and ``gram_bound``, counted from the inputs).

The sweep computes, for each of the P = n(n-1)/2 unique pairs and each site,
the split decomposition's 5 single-bit products (4 exclusive-base channels
and the N channel), plus 10 correction products at each site where some
input holds a 2- or 3-bit IUPAC code: a multiply and an add each, at the b1
tensor-core peak.  Its bytes are each input plane word read once and each
survivor's (row, col, D, NN) int32 written once.  The least time is the
larger of the two, whatever kernel computes the sweep.
"""

from __future__ import annotations

import numpy as np

#: dense int8 tensor-core operations a second of one H100 SXM (data sheet)
PEAK_INT8 = 1979e12
#: single-bit (AND + POPC) tensor-core operations a second: a b1 instruction
#: covers 8 times the sites of the int8 one of the same shape and issues as
#: fast, so 8 x the int8 peak
PEAK_B1 = 8 * PEAK_INT8
#: HBM3 bytes a second of one H100 SXM (data sheet)
PEAK_BYTES = 3.35e12

PRODUCTS_PER_SITE = 5
PRODUCTS_PER_PARTIAL_SITE = 10
SURVIVOR_BYTES = 16


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """(the least seconds the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_work(n: int, length: int, partial_sites: int, survivors: int):
    """(b1 operations, bytes) of one all-pairs sweep."""
    pairs = n * (n - 1) // 2
    ops = 2 * pairs * (PRODUCTS_PER_SITE * length + PRODUCTS_PER_PARTIAL_SITE * partial_sites)
    words = (length + 31) // 32
    bytes_moved = n * 4 * words * 4 + SURVIVOR_BYTES * survivors
    return ops, bytes_moved


def sweep_bound(n: int, length: int, partial_sites: int, survivors: int):
    """(least seconds of one sweep, which bound binds)."""
    ops, bytes_moved = sweep_work(n, length, partial_sites, survivors)
    return bound(bytes_moved, ops, PEAK_B1)


def partial_sites(planes: np.ndarray) -> int:
    """Sites where some sample holds a 2- or 3-bit code."""
    partial = np.zeros(planes.shape[2], dtype=np.uint32)
    for s in range(0, planes.shape[0], 512):
        a, c, g, t = (planes[s: s + 512, k] for k in range(4))
        two_plus = (a & c) | (a & g) | (a & t) | (c & g) | (c & t) | (g & t)
        partial |= np.bitwise_or.reduce(two_plus & ~(a & c & g & t), axis=0)
    return int(np.unpackbits(partial.view(np.uint8)).sum())


def traced_sweep(ctx):
    """(samples, sites, partial sites, survivors) of a traced sweep run,
    counted from its inputs and kept outputs once per run."""
    if not hasattr(ctx, "sweep_shape"):
        cfg = ctx.config
        ctx.sweep_shape = (cfg["samples"], cfg["sites"], partial_sites(ctx.planes),
                           len(ctx.outputs[0][0]))
    return ctx.sweep_shape
