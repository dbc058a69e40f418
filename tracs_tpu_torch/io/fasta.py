"""Minimal, dependency-free FASTA reader and writer (gzip-capable).

Counterpart of tracs_tpu/io/fasta.py.  The bulk packing of sequences into
bit-planes is vectorised in numpy or native code (ops/packing.py), not here.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Tuple


def _open_text(path: str | os.PathLike):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "r", encoding="ascii")


def read_fasta(path: str | os.PathLike) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) records.  Name is the first whitespace token
    after '>' (kseq semantics)."""
    name = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def write_fasta(path: str | os.PathLike, records, width: int = 0) -> None:
    """Write (name, seq) records, gzipped when ``path`` ends in ``.gz``.
    ``width`` > 0 wraps each sequence at that many characters a line; 0 writes
    it on one line (the reference align stage's output)."""
    path = os.fspath(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            if width and width > 0:
                for i in range(0, len(seq), width):
                    fh.write(seq[i : i + width] + "\n")
            else:
                fh.write(seq + "\n")
