"""IUPAC codec: FASTA sequences <-> 4-plane bit-packed allele tensors
(counterpart of tracs_tpu/ops/packing.py; host numpy code, but for the split
layout, which ``split_alignment`` builds on a device).

Canonical layout: ``planes`` is a ``[n_samples, 4, W] uint32`` array, where
plane ``p`` in (A=0, C=1, G=2, T=3) holds one bit per genome position (site
``s`` lives in word ``s // 32``, bit ``s % 32``).  IUPAC ambiguity codes set
several planes; ``N`` (and any unrecognised character, including ``X`` and
``-``) sets all four.  The device path (ops/pairsnp.py) holds the same words
as ``int32`` tensors: bit-identical views, because torch's ``uint32`` has no
``>>`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from tracs_tpu_torch.io.fasta import read_fasta
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.runtime.device import resolve_device
from tracs_tpu_torch.runtime.profiling import count, span, spanned

# bit order: bit0=A, bit1=C, bit2=G, bit3=T
_A, _C, _G, _T = 1, 2, 4, 8

_CHAR_TO_NIBBLE = {
    "A": _A,
    "C": _C,
    "G": _G,
    "T": _T,
    "M": _A | _C,
    "R": _A | _G,
    "W": _A | _T,
    "S": _C | _G,
    "Y": _C | _T,
    "K": _G | _T,
    "V": _A | _C | _G,
    "H": _A | _C | _T,
    "D": _A | _G | _T,
    "B": _C | _G | _T,
    "N": _A | _C | _G | _T,
}

# nibble -> IUPAC character, with 0 -> 'X'; the input codec maps X back to N
IUPAC_BY_NIBBLE = np.frombuffer(b"XACMGRSVTWYHKDBN", dtype="S1")

NIBBLE_LUT = np.full(256, 15, dtype=np.uint8)  # default: N (all four planes)
for ch, nib in _CHAR_TO_NIBBLE.items():
    NIBBLE_LUT[ord(ch)] = nib
    NIBBLE_LUT[ord(ch.lower())] = nib


def iupac_code_for_mask(nibble: int) -> str:
    """IUPAC character for a 4-bit allele-presence mask (bit0=A..bit3=T)."""
    return IUPAC_BY_NIBBLE[nibble].decode()


def nibbles_to_string(nibbles: np.ndarray) -> str:
    """[L] uint8 4-bit masks -> IUPAC string (0 -> 'X')."""
    return IUPAC_BY_NIBBLE[nibbles].tobytes().decode("ascii")


@dataclasses.dataclass
class PackedAlignment:
    """Bit-packed multiple sequence alignment.

    planes : np.uint32 [n, 4, W]  allele-presence bit-planes (W = ceil(L/32);
             padded tail bits are zero — "no allele", which every kernel
             treats as not-a-site)
    length : true genome length L in sites
    names  : per-sequence record names
    """

    planes: np.ndarray
    length: int
    names: list

    @property
    def n_seqs(self) -> int:
        return self.planes.shape[0]


def from_reference(planes, length: int, names) -> PackedAlignment:
    """The port's PackedAlignment from the fields of a ``tracs_tpu``
    PackedAlignment given as numpy arrays (``planes`` uint32 [n, 4, W]),
    so that both packages can be fed identical state."""
    planes = np.ascontiguousarray(planes, dtype=np.uint32)
    if planes.ndim != 3 or planes.shape[1] != 4:
        raise ValueError(f"planes must be [n, 4, W], got {planes.shape}")
    if planes.shape[2] != (int(length) + 31) // 32:
        raise ValueError(f"{planes.shape[2]} words cannot hold length {length}")
    if len(names) != planes.shape[0]:
        raise ValueError(f"{len(names)} names for {planes.shape[0]} sequences")
    return PackedAlignment(planes=planes.copy(), length=int(length), names=list(names))


def seqs_to_nibbles(seqs: Sequence[str | bytes]) -> np.ndarray:
    """Vectorised chars -> 4-bit masks.  All sequences must share a length."""
    if len(seqs) == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    first_len = len(seqs[0])
    for s in seqs:
        if len(s) != first_len:
            raise ValueError("Error reading FASTA, variable sequence lengths!")
    buf = np.empty((len(seqs), first_len), dtype=np.uint8)
    for i, s in enumerate(seqs):
        if isinstance(s, str):
            s = s.encode("ascii")
        buf[i] = np.frombuffer(s, dtype=np.uint8)
    return NIBBLE_LUT[buf]


def nibbles_to_planes(nibbles: np.ndarray) -> np.ndarray:
    """[n, L] uint8 masks -> [n, 4, W] uint32 bit-planes (little bit order)."""
    n, L = nibbles.shape
    W = (L + 31) // 32
    pad = W * 32 - L
    if pad:
        nibbles = np.pad(nibbles, ((0, 0), (0, pad)))
    planes = np.empty((n, 4, W), dtype=np.uint32)
    for p in range(4):
        bits = (nibbles >> p) & 1  # [n, 32W] uint8
        packed = np.packbits(bits, axis=-1, bitorder="little")  # [n, 4W] uint8
        b = packed.reshape(n, W, 4).astype(np.uint32)
        planes[:, p] = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    return planes


def unpack_planes_to_nibbles(planes: np.ndarray, length: int) -> np.ndarray:
    """[n, 4, W] uint32 -> [n, L] uint8 4-bit masks."""
    n, _, W = planes.shape
    out = np.zeros((n, W * 32), dtype=np.uint8)
    for p in range(4):
        bits = np.unpackbits(
            np.ascontiguousarray(planes[:, p]).view(np.uint8), axis=-1, bitorder="little"
        )
        out |= bits << p
    return out[:, :length]


def popcount_words(words: np.ndarray) -> np.ndarray:
    """Vectorised popcount of uint32 words (numpy host path)."""
    v = words.astype(np.uint32).copy()
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


def pack_sequences(seqs: Sequence[str | bytes], names: Sequence[str] | None = None) -> PackedAlignment:
    nib = seqs_to_nibbles(seqs)
    planes = nibbles_to_planes(nib)
    if names is None:
        names = [f"seq{i}" for i in range(len(seqs))]
    return PackedAlignment(planes=planes, length=nib.shape[1], names=list(names))


#: bump to invalidate on-disk pack caches when the plane layout changes
PACKER_VERSION = 1


def pack_cache_key(path: str | os.PathLike) -> str:
    """The cache key of a FASTA: ``PACKER_VERSION`` and the file's identity and
    change stamps, ``(st_dev, st_ino, st_size, st_mtime_ns, st_ctime_ns)``.

    Every one of them is a property of the whole file, read from one
    ``stat`` (reading the content would cost what the cache saves).  The
    kernel sets ``st_ctime`` on every write, rename and ``utime`` and user
    space cannot set it back, so an edit that restores the size and the
    modification time (``touch -r``, ``os.utime``) still re-keys, wherever in
    the file it lies; a copy or an unpacked archive is a new inode and re-keys
    too.  The stamps have the file system's clock granularity."""
    import hashlib

    st = os.stat(path)
    stamp = (PACKER_VERSION, st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns,
             st.st_ctime_ns)
    return hashlib.sha256(repr(stamp).encode()).hexdigest()[:32]


def _pack_cache_load(entry: str) -> PackedAlignment | None:
    """The cached alignment of ``entry`` with its planes as a read-only mmap,
    None when there is no entry; raises ValueError for a corrupt one."""
    import json

    meta_p = os.path.join(entry, "meta.json")
    planes_p = os.path.join(entry, "planes.npy")
    if not os.path.isdir(entry):
        return None
    try:
        with open(meta_p) as fh:
            meta = json.load(fh)
        planes = np.load(planes_p, mmap_mode="r")
        length, names = int(meta["length"]), list(meta["names"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise ValueError(f"unreadable entry: {e}") from e
    if meta.get("version") != PACKER_VERSION or planes.dtype != np.uint32 \
            or planes.shape != (len(names), 4, (length + 31) // 32):
        raise ValueError(f"entry of version {meta.get('version')} holds planes "
                         f"{planes.dtype}{planes.shape} for {len(names)} names of length {length}")
    return PackedAlignment(planes=planes, length=length, names=names)


def _pack_cache_store(entry: str, packed: PackedAlignment) -> None:
    """Writes the entry into a temporary directory beside it and publishes it
    with one ``os.rename``, so a reader sees a whole entry or none."""
    import json
    import shutil
    import tempfile

    parent = os.path.dirname(entry)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".pack-")
    try:
        np.save(os.path.join(tmp, "planes.npy"), packed.planes)
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump({"version": PACKER_VERSION, "length": packed.length,
                       "names": packed.names}, fh)
        try:
            os.rename(tmp, entry)
        except OSError:
            if not os.path.isdir(entry):  # else another process published it first
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _pack_uncached(path: str) -> PackedAlignment:
    from tracs_tpu_torch.runtime.native import native_pack_fasta

    got = native_pack_fasta(path)
    if got is not None:
        planes, length, names = got
        return PackedAlignment(planes=planes, length=length, names=names)
    names, seqs = [], []
    for name, seq in read_fasta(path):
        names.append(name)
        seqs.append(seq)
    if not seqs:
        raise ValueError(f"No sequences found in {path!r}")
    return pack_sequences(seqs, names)


def pack_fasta(path: str | os.PathLike,
               cache_dir: str | os.PathLike | None = None) -> PackedAlignment:
    """Load an aligned (equal-length) FASTA/FASTA.gz into bit-planes, with
    the native packer when it builds and the numpy packer otherwise.

    With ``cache_dir`` the planes are kept on disk under
    ``cache_dir/<pack_cache_key(path)>`` (``planes.npy`` and ``meta.json``,
    published by an atomic rename), and a later call on the unchanged file
    loads them as a read-only mmap instead of parsing the FASTA.  A store
    that fails logs a warning and the packed planes are returned all the
    same; a corrupt entry is reported, removed and re-packed.

    Deviation from tracs_tpu: the cache is off unless ``cache_dir`` is given
    (``tracs-tpu-torch distance --pack-cache DIR``); there is no default
    directory and no ``TRACS_TPU_PACK_CACHE``, so nothing is written that the
    caller did not ask for.  ``cache_dir`` is the only switch: a file of any
    size is cached when it is given (tracs_tpu skips files under 64 MB by
    default)."""
    import logging

    path = os.fspath(path)
    entry = None
    if cache_dir is not None:
        try:
            entry = os.path.join(os.fspath(cache_dir), pack_cache_key(path))
        except OSError:
            entry = None  # the packer reports a missing file
    if entry is not None:
        try:
            cached = _pack_cache_load(entry)
        except ValueError as e:
            import shutil

            logging.warning("pack cache: %s is corrupt (%s); re-packing %s", entry, e, path)
            shutil.rmtree(entry, ignore_errors=True)
            cached = None
        if cached is not None:
            logging.info("pack cache: loaded %s from %s", path, entry)
            return cached
    packed = _pack_uncached(path)
    if entry is not None:
        try:
            _pack_cache_store(entry, packed)
        except OSError as e:
            logging.warning("pack cache: could not store %s in %s (%s)", path, entry, e)
    return packed


@dataclasses.dataclass
class SplitAlignment:
    """Match-decomposed layout for the distance kernel (ops/pairsnp.py):

        match(u, v) = sum_x ex_x(u) ex_x(v)            [4 dense channels]
                      - n(u) n(v) + n(u) + n(v)        [1 dense channel + counts]
                      + partial-ambiguity correction   [10 channels, gathered]

    where ``ex`` are the N-exclusive singleton planes (plane & ~N-mask) and
    the correction channels are nonzero only at sites where some sample holds
    a 2- or 3-bit IUPAC code — gathered into a compact [n, 4, Wp] tensor.

    The planes live only on a device: ``_dev_cache`` maps a device to its
    tensors (excl int32 [n, 4, W'], nmask int32 [n, W'], partial int32
    [n, 4, Wp'] at the card's word pitch, cnt_n int32 [n]), read through
    ops/pairsnp.py::_split_device.  ``split_alignment`` fills the entry of
    ``device``; another device builds its own from ``src`` on first use.
    """

    cnt_n: np.ndarray     # [n] int64: per-sample N counts
    length: int
    n_partial: int
    names: list
    partial_pos: np.ndarray  # [n_partial] int64 gathered positions
    # the PackedAlignment this layout was built from
    src: PackedAlignment
    # the device the layout was built on
    device: torch.device
    _dev_cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def n_seqs(self) -> int:
        return len(self.cnt_n)


def partial_site_positions(packed: PackedAlignment) -> np.ndarray:
    """Positions (int64) where ANY sample holds a partial (2-/3-bit IUPAC)
    code.  The correction gram of a PAIR of alignments needs both sides
    gathered at the SAME position set: use the union of both sides'."""
    p = packed.planes
    a, c, g, t = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    all4 = a & c & g & t
    ge2 = (a & c) | (a & g) | (a & t) | (c & g) | (c & t) | (g & t)
    global_partial = np.bitwise_or.reduce((ge2 & ~all4).astype(np.uint32), axis=0)
    bits = np.unpackbits(global_partial.view(np.uint8), bitorder="little")
    return np.nonzero(bits[: packed.length])[0].astype(np.int64)


@spanned("layout.split")
def split_alignment(
    packed: PackedAlignment, partial_sites: np.ndarray | None = None, *,
    device: str | torch.device | None = None,
) -> SplitAlignment:
    """Build the SplitAlignment layout (once per alignment) on ``device``
    (None: the CPU) from the raw planes, which cross to it once (the span
    ``layout.upload``, the counter ``layout.upload_bytes``):
    ``kernels.split_layout`` writes the exclusive planes and N masks at the
    card's word pitch, each sample's N count and the partial-site OR over
    the samples; only the counts and the OR come back, the partial sites
    are read from the OR and ``kernels.split_gather`` gathers the partial
    planes on the device.  A build on a card is counted in
    ``layout.device_builds``.  On the CPU the kernels' plain versions run.

    ``partial_sites`` overrides the gathered partial-site positions — pass
    the union of both alignments' positions when building the two sides of
    a query-vs-db pair, so their correction grams share the gather axis."""
    device = resolve_device("cpu" if device is None else device)
    with span("layout.upload"):
        planes = kernels._as_words(packed.planes).to(device)
    count("layout.upload_bytes", packed.planes.nbytes)
    excl, nmask, cnt, partial_or = kernels.split_layout(planes)
    del planes
    cnt_n = cnt.cpu().numpy().astype(np.int64)
    if partial_sites is None:
        bits = np.unpackbits(partial_or.cpu().numpy().view(np.uint8), bitorder="little")
        partial_sites = np.nonzero(bits[: packed.length])[0]
    idx = np.asarray(partial_sites, dtype=np.int64)
    partial = kernels.split_gather(excl, idx)
    if device.type == "cuda":
        count("layout.device_builds")
    return SplitAlignment(
        cnt_n=cnt_n, length=packed.length, n_partial=len(idx),
        names=packed.names, partial_pos=idx, src=packed, device=device,
        _dev_cache={device: (excl, nmask, partial, cnt)},
    )


# ---------------------------------------------------------------------------
# variant-site compaction
# ---------------------------------------------------------------------------

def _gather_columns(planes: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Repack the selected columns of a [n, 4, W] plane tensor into a fresh
    [n, 4, ceil(V/32)] tensor (little bit order), chunked over rows to bound
    the temporary bit matrix."""
    n = planes.shape[0]
    V = int(positions.size)
    word_idx = (positions >> 5).astype(np.int64)
    bit_idx = (positions & 31).astype(np.uint32)
    Wc = (V + 31) // 32
    out_bytes = np.zeros((n, 4, Wc * 4), dtype=np.uint8)
    rows_per_chunk = max(1, (1 << 26) // max(1, 4 * V))
    for s in range(0, n, rows_per_chunk):
        e = min(n, s + rows_per_chunk)
        bits = ((planes[s:e][:, :, word_idx] >> bit_idx) & 1).astype(np.uint8)
        packed = np.packbits(bits, axis=-1, bitorder="little")  # [r, 4, ceil(V/8)]
        out_bytes[s:e, :, : packed.shape[-1]] = packed
    return np.ascontiguousarray(out_bytes).view(np.uint32).reshape(n, 4, Wc)


@spanned("layout.compact")
def compact_variant_columns(
    a: PackedAlignment,
    b: PackedAlignment | None = None,
    *,
    max_ratio: float = 0.75,
):
    """Drop alignment columns that cannot affect any pairwise result.

    A column where every sample (of both alignments, in query-vs-db mode)
    holds the SAME nonzero nibble contributes exactly one match to every
    pair, so the compacted distance matrix equals the full one.  Comparable-
    site counts shift by the constant ``nn_offset = L - V - n_droppedN``.

    Returns ``(a_c, b_c, positions, nn_offset)`` or ``None`` when fewer
    than ``(1 - max_ratio)`` of the columns would be dropped.
    """
    same = b is None or b is a
    planes_list = [a.planes] if same else [a.planes, b.planes]
    L, W = a.length, a.planes.shape[2]
    if a.planes.shape[0] == 0 or (not same and b.planes.shape[0] == 0):
        return None

    and_all = None
    or_all = None
    for pl in planes_list:
        pa = np.bitwise_and.reduce(pl, axis=0)  # [4, W]
        po = np.bitwise_or.reduce(pl, axis=0)
        and_all = pa if and_all is None else (and_all & pa)
        or_all = po if or_all is None else (or_all | po)

    varies = (
        (and_all[0] ^ or_all[0])
        | (and_all[1] ^ or_all[1])
        | (and_all[2] ^ or_all[2])
        | (and_all[3] ^ or_all[3])
    )
    nz = or_all[0] | or_all[1] | or_all[2] | or_all[3]
    in_l = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    tail = W * 32 - L
    if tail:
        in_l[-1] = np.uint32(0xFFFFFFFF >> tail)
    keep = (varies | ~nz) & in_l

    positions = np.nonzero(
        np.unpackbits(keep.view(np.uint8), bitorder="little")
    )[0].astype(np.int64)
    if positions.size == 0:
        # keep one (constant, nonzero) column so kernels see >= 1 site;
        # it contributes one match to every pair, exactly as it did in full
        positions = np.array([0], dtype=np.int64)
        keep = keep.copy()
        keep[0] |= np.uint32(1)
    V = int(positions.size)
    if V >= max_ratio * L:
        return None

    const_n = and_all[0] & and_all[1] & and_all[2] & and_all[3]
    dropped_n = int(popcount_words(const_n & ~keep & in_l).sum())
    nn_offset = L - V - dropped_n

    a_c = PackedAlignment(_gather_columns(a.planes, positions), V, a.names)
    b_c = a_c if same else PackedAlignment(_gather_columns(b.planes, positions), V, b.names)
    return a_c, b_c, positions, nn_offset
