"""All-pairs SNP distances of bit-packed IUPAC alignments, in plain PyTorch.

A site matches when the two samples share an allele bit (N sets all four, so
it matches everything); ``d = L - matches`` and the comparable-site count is
``nn = L - (sites where either sample is N)``.  Each site's 4-bit code is
unpacked on the device; with one-hot channels U_x(i) = [code_i == x] over the
codes x that occur (N apart) and V_x(j) = [code_j & x != 0], matches(i, j) =
sum_x <U_x(i), V_x(j)> + cntN(i), an exact int8 product with int32 sums.

``partial_correction=False`` is the control: it counts every shared allele
bit as a match, so a pair of 2-bit codes that share both bits counts two
matches at one site, the sum a gram kernel gives when the correction for
partial IUPAC codes is left out.
"""

from __future__ import annotations

import numpy as np
import torch

_N = 15


def codes(planes: np.ndarray, length: int, device, row_chunk: int = 128):
    """(uint8 [n, L'] 4-bit codes (bit0=A .. bit3=T) of uint32 planes
    [n, 4, W], the codes that occur): L' is L rounded up to a multiple of 8,
    the padding sites coded 0."""
    n, _, W = planes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=device)
    width = -(-length // 8) * 8
    out = torch.zeros(n, width, dtype=torch.uint8, device=device)
    seen = torch.zeros(16, dtype=torch.long, device=device)
    for s in range(0, n, row_chunk):
        p = torch.from_numpy(np.ascontiguousarray(planes[s: s + row_chunk]).view(np.int32))
        p = p.to(device)
        for c in range(4):
            bits = ((p[:, c, :, None] >> shifts) & 1).to(torch.uint8).reshape(p.shape[0], -1)
            out[s: s + row_chunk, :length] |= bits[:, :length] << c
        seen += torch.bincount(out[s: s + row_chunk, :length].reshape(-1).long(), minlength=16)
    return out, [x for x in range(16) if seen[x] > 0]


def _gram(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """int64 [m, k] = u [m, K] . v [k, K]^T for 0/1 int8 operands, K a
    multiple of 8: exact int32 sums on the card, float64 ones on the CPU."""
    if u.device.type == "cuda":
        m, k = u.shape[0], v.shape[0]
        if m <= 16 or k % 8:  # the shapes torch._int_mm takes
            u = torch.nn.functional.pad(u, (0, 0, 0, max(0, 17 - m)))
            v = torch.nn.functional.pad(v, (0, 0, 0, -k % 8))
        return torch._int_mm(u, v.t())[:m, :k].long()
    return (u.double() @ v.double().t()).round().long()


class Distances:
    """D and NN of row blocks of an alignment against all of it."""

    def __init__(self, planes: np.ndarray, length: int, device, *, partial_correction=True,
                 site_chunk: int = 1 << 15):
        self.length = length
        self.code, present = codes(planes, length, device)
        self.channels = [x for x in present if x not in (0, _N)]
        self.partial_correction = partial_correction
        self.site_chunk = site_chunk
        self.cnt_n = torch.cat([(self.code[s: s + 128] == _N).sum(dim=1)
                                for s in range(0, self.code.shape[0], 128)]).long()

    def _operands(self, code: torch.Tensor, side: str) -> torch.Tensor:
        """int8 [rows, channels x sites] operand of one side of the gram."""
        if not self.partial_correction:
            # every allele bit of a non-N site on both sides (the control)
            not_n = code != _N
            return torch.cat([(((code >> c) & 1) != 0) & not_n for c in range(4)],
                             dim=1).to(torch.int8)
        if side == "u":
            return torch.cat([code == x for x in self.channels], dim=1).to(torch.int8)
        return torch.cat([(code & x) != 0 for x in self.channels], dim=1).to(torch.int8)

    def block(self, r0: int, r1: int):
        """(d, nn) int64 [r1 - r0, n] of rows [r0, r1) against every sample."""
        n = self.code.shape[0]
        matches = torch.zeros(r1 - r0, n, dtype=torch.long, device=self.code.device)
        both_n = torch.zeros_like(matches)
        for s in range(0, self.code.shape[1], self.site_chunk):
            cu = self.code[r0:r1, s: s + self.site_chunk]
            cv = self.code[:, s: s + self.site_chunk]
            both_n += _gram((cu == _N).to(torch.int8), (cv == _N).to(torch.int8))
            if self.channels or not self.partial_correction:
                matches += _gram(self._operands(cu, "u"), self._operands(cv, "v"))
        cnt_a, cnt_b = self.cnt_n[r0:r1, None], self.cnt_n[None, :]
        # an N site matches everything: once a pair, whoever holds the N
        matches += cnt_a if self.partial_correction else cnt_a + cnt_b - both_n
        nn = self.length - cnt_a - cnt_b + both_n
        return self.length - matches, nn

    def survivors(self, dist: int, block_rows: int = 1024):
        """(rows, cols, d, nn) int64 numpy arrays of the pairs i < j with
        d <= dist, in row-major order."""
        out = []
        n = self.code.shape[0]
        for r0 in range(0, n, block_rows):
            r1 = min(n, r0 + block_rows)
            d, nn = self.block(r0, r1)
            cols = torch.arange(n, device=d.device)[None, :]
            rows = torch.arange(r0, r1, device=d.device)[:, None]
            keep = (d <= dist) & (cols > rows)
            i, j = torch.nonzero(keep, as_tuple=True)
            out.append([x.cpu().numpy() for x in (i + r0, j, d[i, j], nn[i, j])])
        return tuple(np.concatenate([o[k] for o in out]) for k in range(4))

    def mismatch_positions(self, rows: np.ndarray, cols: np.ndarray, batch: int = 256):
        """(pair index, site) int64 arrays of every site where the two samples
        of a pair share no allele bit, ascending within each pair."""
        pair, site = [], []
        dev = self.code.device
        for s in range(0, len(rows), batch):
            ri = torch.from_numpy(rows[s: s + batch]).to(dev)
            ci = torch.from_numpy(cols[s: s + batch]).to(dev)
            shared = self.code[ri, : self.length] & self.code[ci, : self.length]
            p, x = torch.nonzero(shared == 0, as_tuple=True)
            pair.append((p + s).cpu().numpy())
            site.append(x.cpu().numpy())
        if not pair:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        return np.concatenate(pair), np.concatenate(site)
