"""htsbox pileup text -> [L, 4] allele-count matrices (counterpart of
tracs_tpu/io/pileup.py; host only).

The native parser (``tn_parse_pileup`` of src/tracs_native.cpp) is used when
the library is built; the Python route keeps the same semantics:

* only single-character A/C/G/T alleles count, and only where the reference
  base itself is one of A/C/G/T (case-sensitive);
* with ``require_both_strands``, an allele seen on one strand only counts 0;
* positions are 1-based in the file; the contigs are laid out one after the
  other in the order of ``contig_lengths`` (the reference genome's records).
"""

from __future__ import annotations

import gzip
import logging
import os

import numpy as np

from tracs_tpu_torch.runtime.native import get_lib

_NPOS = {"A": 0, "C": 1, "G": 2, "T": 3}


def _open_text(path):
    if os.fspath(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def parse_pileup(path, contig_lengths: dict[str, int], require_both_strands: bool = True) -> np.ndarray:
    """Parse a pileup into one concatenated [sum(L_c), 4] float64 matrix, with
    rows laid out contig after contig in ``contig_lengths`` order."""
    offsets = {}
    total = 0
    for name, length in contig_lengths.items():
        offsets[name] = total
        total += int(length)

    native = _parse_native(path, offsets, total, require_both_strands)
    if native is not None:
        return native

    counts = np.zeros((total, 4), dtype=float)
    with _open_text(path) as infile:
        for line in infile:
            line = line.strip().split()
            if len(line) < 4:
                continue
            contig = line[0]
            if contig not in offsets:
                continue
            pos = int(line[1]) - 1
            nucs = line[-2].split(",")
            ncounts = line[-1].split(":")[1:]
            row = np.zeros(4, dtype=float)
            for nuc, c1, c2 in zip(nucs, ncounts[0].split(","), ncounts[1].split(",")):
                c1 = int(c1)
                c2 = int(c2)
                if (nuc not in _NPOS) or (line[2] not in _NPOS):
                    continue
                if require_both_strands and (c1 == 0 or c2 == 0):
                    c1 = c2 = 0
                row[_NPOS[nuc]] = c1 + c2
            counts[offsets[contig] + pos, :] = row
    return counts


def scan_pileup_depth(path):
    """Total allele depth of every pileup line, as an int64 array (one entry
    per line).  The htsbox count column lists two quality summaries followed
    by per-allele per-strand counts; the depth is the sum of everything after
    the first two numbers.  A truncated gzip file yields the depths read so
    far (None if nothing was readable)."""
    depths = []
    try:
        with _open_text(path) as fh:
            for line in fh:
                parts = line.rsplit(None, 2)
                if len(parts) < 3:
                    continue
                nums = parts[-1].replace(":", ",").split(",")
                try:
                    depths.append(sum(int(x) for x in nums[2:]))
                except ValueError:
                    continue
    except EOFError:
        logging.warning("truncated pileup %s: %d lines read", path, len(depths))
    if not depths:
        return None
    return np.asarray(depths, dtype=np.int64)


def _parse_native(path, offsets: dict[str, int], total: int, require_both_strands: bool):
    """The native route: float32 counts widened to float64, or None when the
    library is unavailable or refuses the file."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.zeros((total, 4), dtype=np.float32)
    offs = np.asarray(list(offsets.values()), dtype=np.int64)
    names = np.frombuffer(b"".join(name.encode() + b"\x00" for name in offsets), dtype=np.uint8)
    rc = lib.tn_parse_pileup(
        os.fspath(path).encode(), counts, total, offs, len(offs),
        np.ascontiguousarray(names), len(names), 1 if require_both_strands else 0,
    )
    if rc < 0:
        logging.warning("native pileup parse failed (%s); falling back", rc)
        return None
    return counts.astype(float)
