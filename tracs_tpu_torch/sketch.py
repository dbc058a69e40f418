"""Native FracMinHash sketching + greedy gather: reference-genome selection
without the ``sourmash`` binary (counterpart of tracs_tpu/sketch.py; host
numpy and the native library, no device code).

Scaled-minhash sketches (canonical rolling k-mer hashes kept when
h <= 2^64 / scaled) come from the native C++ library (src/tracs_native.cpp,
with a Python route of the same maths), and the sourmash-gather greedy
containment algorithm runs over them.  The align stage uses this whenever a
database zip carries ``native_sketches.npz`` and no SBT index, or sourmash is
absent.

Hash values are NOT sourmash-compatible (another hash function): native
sketches and sourmash SBTs are separate worlds; a database zip may carry
either or both.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import zipfile

import numpy as np

_MASK64 = (1 << 64) - 1

# fixed per-base constants — MUST match kBaseH in src/tracs_native.cpp
_BASE_H = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456],
    dtype=np.uint64,
)
_CODE = np.full(256, -1, dtype=np.int8)
for i, ch in enumerate("ACGT"):
    _CODE[ord(ch)] = i
    _CODE[ord(ch.lower())] = i


def _rol(x: int, r: int) -> int:
    r &= 63
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _sketch_seq_py(seq: str, k: int, max_hash: int, out: set) -> None:
    """Pure-Python rolling canonical hash (fallback; same maths as native)."""
    codes = _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
    fh = rh = 0
    filled = 0
    ring = [0] * k
    pos = 0
    H = [int(h) for h in _BASE_H]
    for b in codes:
        if b < 0:
            fh = rh = 0
            filled = 0
            pos = 0
            continue
        b = int(b)
        if filled < k:
            fh = (_rol(fh, 1) ^ H[b]) & _MASK64
            rh = (rh ^ _rol(H[3 - b], filled)) & _MASK64
            ring[pos] = b
            pos = (pos + 1) % k
            filled += 1
            if filled < k:
                continue
        else:
            old = ring[pos]
            fh = (_rol(fh, 1) ^ _rol(H[old], k) ^ H[b]) & _MASK64
            rh = _rol(rh ^ H[3 - old] ^ _rol(H[3 - b], k), 63) & _MASK64
            ring[pos] = b
            pos = (pos + 1) % k
        ch = fh if fh < rh else rh
        if ch <= max_hash:
            out.add(ch)


def sketch_file(path, ksize: int = 51, scaled: int = 1000) -> np.ndarray:
    """Sorted uint64 FracMinHash sketch of a FASTA/FASTQ(.gz) file."""
    from tracs_tpu_torch.runtime.native import get_lib

    max_hash = _MASK64 // scaled
    lib = get_lib()
    if lib is not None:
        cap = 1 << 22
        buf = np.empty(cap, dtype=np.uint64)
        n = lib.tn_sketch_file(os.fspath(path).encode(), ksize, scaled, buf, cap)
        if n == -5:
            cap = 1 << 26
            buf = np.empty(cap, dtype=np.uint64)
            n = lib.tn_sketch_file(os.fspath(path).encode(), ksize, scaled, buf, cap)
        if n >= 0:
            return buf[:n].copy()
        logging.warning("native sketch failed (%s); python fallback", n)

    from tracs_tpu_torch.io.fasta import read_fasta

    out: set = set()
    path_s = os.fspath(path)
    if _looks_fastq(path_s):
        for seq in _read_fastq_seqs(path_s):
            _sketch_seq_py(seq, ksize, max_hash, out)
    else:
        for _name, seq in read_fasta(path_s):
            _sketch_seq_py(seq, ksize, max_hash, out)
    return np.array(sorted(out), dtype=np.uint64)


def _looks_fastq(path: str) -> bool:
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for line in fh:
            if line.strip():
                return line[0] == "@"
    return False


def _read_fastq_seqs(path: str):
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                yield line.strip()


@dataclasses.dataclass
class GatherHit:
    name: str
    intersect_bp: int
    f_orig_query: float
    f_match: float
    f_unique_to_query: float


def gather(
    query: np.ndarray,
    refs: dict[str, np.ndarray],
    *,
    scaled: int = 1000,
    threshold_bp: int = 50000,
) -> list[GatherHit]:
    """Greedy minimum-set-cover gather (the sourmash gather algorithm): pick
    the reference covering the most remaining query hashes, subtract, repeat
    while the unique overlap stays above threshold_bp."""
    query = np.asarray(query, dtype=np.uint64)
    nq = len(query)
    if nq == 0:
        return []
    remaining = query
    hits: list[GatherHit] = []
    used = set()
    min_hashes = max(1, threshold_bp // scaled)
    while True:
        best, best_n = None, 0
        for name, r in refs.items():
            if name in used:
                continue
            n = np.intersect1d(remaining, r, assume_unique=True).size
            if n > best_n:
                best, best_n = name, n
        if best is None or best_n < min_hashes:
            break
        r = refs[best]
        orig = np.intersect1d(query, r, assume_unique=True).size
        hits.append(
            GatherHit(
                name=best,
                intersect_bp=orig * scaled,
                f_orig_query=orig / nq,
                f_match=orig / max(1, len(r)),
                f_unique_to_query=best_n / nq,
            )
        )
        used.add(best)
        remaining = np.setdiff1d(remaining, r, assume_unique=True)
    return hits


def write_hits_csv(hits: list[GatherHit], path: str) -> None:
    """sourmash-gather-compatible column layout for the fields downstream
    code reads: [0]=intersect_bp, [1]=f_orig_query, [2]=f_match,
    [3]=f_unique_to_query, [8]=filename-ish, [9]=name (reference
    tracs/utils.py:64-82, tracs/combine.py:172-184)."""
    with open(path, "w") as fh:
        fh.write(
            "intersect_bp,f_orig_query,f_match,f_unique_to_query,"
            "average_abund,median_abund,std_abund,filename,md5,name\n"
        )
        for h in hits:
            fh.write(
                f"{h.intersect_bp},{h.f_orig_query},{h.f_match},"
                f"{h.f_unique_to_query},0,0,0,native,na,\"{h.name}\"\n"
            )


# ---------------------------------------------------------------------------
# database zip integration
# ---------------------------------------------------------------------------

SKETCH_MEMBER = "native_sketches.npz"


def write_db_sketches(zippath, inputs, ksize: int = 51, scaled: int = 1000) -> None:
    """Append native sketches for (path, prefix) genome pairs to a db zip."""
    import io

    arrays = {}
    for path, prefix in inputs:
        arrays[prefix] = sketch_file(path, ksize=ksize, scaled=scaled)
    buf = io.BytesIO()
    np.savez_compressed(buf, __meta__=np.array([ksize, scaled], dtype=np.int64), **arrays)
    with zipfile.ZipFile(zippath, "a") as z:
        z.writestr(SKETCH_MEMBER, buf.getvalue())


def load_db_sketches(zippath):
    """(refs dict, ksize, scaled) from a db zip, or None if absent."""
    import io

    with zipfile.ZipFile(zippath, "r") as z:
        if SKETCH_MEMBER not in z.namelist():
            return None
        data = z.read(SKETCH_MEMBER)
    npz = np.load(io.BytesIO(data))
    ksize, scaled = (int(x) for x in npz["__meta__"])
    refs = {k: npz[k] for k in npz.files if k != "__meta__"}
    return refs, ksize, scaled


def native_gather(input_files, database_zip, output_csv) -> list[str]:
    """Drop-in for io.external.run_gather using native sketches in the db
    zip.  Returns selected reference names (the same hit-selection rule as
    the reference: f_unique >= 0.1, or within 98% of the previous hit's
    coverage, reference tracs/utils.py:70-82)."""
    loaded = load_db_sketches(database_zip)
    if loaded is None:
        raise ValueError(f"{database_zip} has no {SKETCH_MEMBER}")
    refs, ksize, scaled = loaded

    q = None
    for f in input_files:
        s = sketch_file(f, ksize=ksize, scaled=scaled)
        q = s if q is None else np.union1d(q, s)

    hits = gather(q, refs, scaled=scaled)
    write_hits_csv(hits, output_csv)

    references = []
    prev = True
    hits_sorted = sorted(hits, key=lambda h: h.intersect_bp, reverse=True)
    if not hits_sorted:
        return references
    pcov = hits_sorted[0].intersect_bp
    for h in hits_sorted:
        if (h.f_match >= 0.1) or (prev and pcov and (h.intersect_bp / pcov >= 0.98)):
            logging.info("Using reference: %s", h.name)
            references.append(h.name)
        else:
            prev = False
        pcov = h.intersect_bp
    return references
