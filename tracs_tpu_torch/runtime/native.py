"""ctypes loader for the native C++ host library ``src/tracs_native.cpp``
(counterpart of tracs_tpu/runtime/native.py): FASTA packing, the recombination filter's window passes, CSV row formatting,
the distance-CSV reader of the ``cluster`` stage, and the pileup parser and
FracMinHash sketcher of the ``align`` stage (``tn_parse_pileup`` and
``tn_sketch_file``, called by io/pileup.py and sketch.py on ``get_lib()``).

The library is built with g++ into the git-ignored ``build/native/`` at
first use (runtime/build.py).  Every entry point returns None when the
library cannot be built, and its caller then takes a numpy path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from tracs_tpu_torch.runtime.build import BUILD_DIR, REPO_ROOT, BuildError, compile_library

_SRC = os.path.join(REPO_ROOT, "src", "tracs_native.cpp")

_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None | bool" = None  # None = not tried, False = unavailable


def get_lib():
    """Return the loaded CDLL, building it on first use; None if unavailable."""
    global _LIB
    with _LOCK:
        if _LIB is False:
            return None
        if _LIB is not None:
            return _LIB
        argv = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
            "-std=c++17", _SRC, "-o", "{out}", "-lz",
        ]
        try:
            path, _ = compile_library(_SRC, os.path.join(BUILD_DIR, "native"),
                                      "tracs_native", argv, timeout=300)
            lib = ctypes.CDLL(path)
        except (BuildError, OSError) as e:
            logging.warning("native host library unavailable, using numpy: %s", e)
            _LIB = False
            return None
        _configure(lib)
        _LIB = lib
        return lib


def _configure(lib) -> None:
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")

    lib.tn_fasta_scan.restype = ctypes.c_int64
    lib.tn_fasta_scan.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]

    lib.tn_fasta_pack.restype = ctypes.c_int64
    lib.tn_fasta_pack.argtypes = [
        ctypes.c_char_p, u32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
    ]

    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    lib.tn_parse_pileup.restype = ctypes.c_int64
    lib.tn_parse_pileup.argtypes = [
        ctypes.c_char_p, f32p, ctypes.c_int64,       # path, counts [L, 4], L
        i64p, ctypes.c_int64,                        # contig offsets, n_contigs
        u8p, ctypes.c_int64, ctypes.c_int,           # names blob, its length, both strands
    ]

    u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    lib.tn_sketch_file.restype = ctypes.c_int64
    lib.tn_sketch_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, u64p, ctypes.c_int64,
    ]

    lib.tn_dist_csv_scan.restype = ctypes.c_int64
    lib.tn_dist_csv_scan.argtypes = [ctypes.c_char_p]

    lib.tn_read_dist_csv.restype = ctypes.c_int64
    lib.tn_read_dist_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,   # path, column, threshold
        i64p, i64p, ctypes.c_int64,                         # I, J, their capacity
        ctypes.c_char_p, ctypes.c_int64, i64p,              # names blob, its capacity, n_out
    ]

    lib.tn_format_dist_rows.restype = ctypes.c_int64
    lib.tn_format_dist_rows.argtypes = [
        ctypes.c_char_p, i64p,                       # names blob + offsets
        i64p, i64p, ctypes.c_int64,                  # rows, cols, n
        ctypes.c_void_p, i64p,                       # datediff|NULL, dvals
        ctypes.c_void_p, ctypes.c_void_p,            # p0|NULL, eK|NULL
        ctypes.c_void_p,                             # filt|NULL
        i64p, ctypes.c_char_p, ctypes.c_int64,       # nn, ref, ref_len
        ctypes.c_char_p, ctypes.c_int64,             # out, cap
    ]

    lib.tn_window_stats.restype = None
    lib.tn_window_stats.argtypes = [
        i64p, ctypes.c_int64,          # pos, n_snps
        i64p, ctypes.c_int64,          # seg_bounds, n_pairs
        i64p, i32p, i64p,              # w, count out, span out
    ]

    lib.tn_filter_windows.restype = None
    lib.tn_filter_windows.argtypes = [
        i64p, ctypes.c_int64,          # pos, n_snps
        i64p, ctypes.c_int64,          # seg_bounds, n_pairs
        i64p,                          # w
        u8p, i64p, i64p,               # tables, tab_off, tab_width
        ctypes.c_int64,                # cap
        i64p, u8p,                     # kept out, ovf_mark out
    ]


def native_pack_fasta(path):
    """Parse + bit-pack an aligned FASTA via the native library.

    Returns (planes [n, 4, W] uint32, length, names) or None when the native
    path is unavailable (the caller falls back to the numpy packer).
    """
    lib = get_lib()
    if lib is None:
        return None
    path_b = os.fspath(path).encode()
    seq_len = ctypes.c_int64(0)
    n = lib.tn_fasta_scan(path_b, ctypes.byref(seq_len))
    if n == -2:
        raise ValueError("Error reading FASTA, variable sequence lengths!")
    if n < 0:
        raise ValueError(f"Error reading FASTA {os.fspath(path)!r}")
    if n == 0:
        raise ValueError(f"No sequences found in {path!r}")
    L = seq_len.value
    W = (L + 31) // 32
    planes = np.zeros((n, 4, W), dtype=np.uint32)
    name_cap = 4096
    names_buf = ctypes.create_string_buffer(n * name_cap)
    rc = lib.tn_fasta_pack(path_b, planes, n, L, names_buf, name_cap)
    if rc < 0:
        raise ValueError(f"Error packing FASTA {path!r} (code {rc})")
    names = [
        names_buf.raw[i * name_cap : (i + 1) * name_cap].split(b"\x00", 1)[0].decode()
        for i in range(n)
    ]
    return planes, L, names


def _names_blob(names):
    """Concatenated UTF-8 names + int64 offsets for tn_format_dist_rows."""
    offs = np.zeros(len(names) + 1, dtype=np.int64)
    parts = []
    pos = 0
    for i, nm in enumerate(names):
        b = nm.encode()
        parts.append(b)
        pos += len(b)
        offs[i + 1] = pos
    return b"".join(parts), offs


def native_format_rows(names, rows, cols, dvals, nn, ref, datediff=None, p0=None,
                       eK=None, filt=None, *, blob_cache=None):
    """Format distance-CSV rows with the native writer; None if unavailable.

    ``datediff``, ``p0`` and ``eK`` fill the date difference, transmission
    distance and expected K columns (float64, Python repr text); ``None``
    writes NA there, as does ``filt`` None in the filtered column.
    ``blob_cache``: optional dict to reuse the names blob across row blocks
    of a streaming run.
    """
    lib = get_lib()
    if lib is None or len(rows) == 0:
        return None

    if blob_cache is not None and "blob" in blob_cache:
        blob, offs = blob_cache["blob"]
    else:
        blob, offs = _names_blob(names)
        if blob_cache is not None:
            blob_cache["blob"] = (blob, offs)

    n = len(rows)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    dvals = np.ascontiguousarray(dvals, dtype=np.int64)
    nn = np.ascontiguousarray(nn, dtype=np.int64)
    # the arrays stay referenced here until the writer returns
    dd_arr, p0_arr, ek_arr = (None if x is None else np.ascontiguousarray(x, dtype=np.float64)
                              for x in (datediff, p0, eK))
    ft_arr = None if filt is None else np.ascontiguousarray(filt, dtype=np.int64)
    dd_p, p0_p, ek_p, ft_p = (None if x is None else x.ctypes.data_as(ctypes.c_void_p)
                              for x in (dd_arr, p0_arr, ek_arr, ft_arr))

    name_lens = offs[1:] - offs[:-1]
    ref_b = ref.encode()
    cap = int(
        name_lens[rows].sum() + name_lens[cols].sum()
        + n * (3 * 32 + 3 * 21 + 16 + len(ref_b))
    )
    out = ctypes.create_string_buffer(cap)
    wrote = lib.tn_format_dist_rows(
        blob, offs, rows, cols, n,
        dd_p, dvals, p0_p, ek_p, ft_p,
        nn, ref_b, len(ref_b), out, cap,
    )
    if wrote < 0:
        return None
    return ctypes.string_at(out, wrote).decode()


def native_read_dist_csv(path, col_index, threshold):
    """Parse a distance CSV for the cluster stage via the native reader.

    Returns (I, J, names, n_rows): edge endpoint ids (first-appearance
    order) of the rows whose column ``col_index`` is <= ``threshold``, the
    id-ordered sample names, and the data row count; None when the native
    library is unavailable or cannot open the file.  Raises ValueError on a
    non-numeric metric field (``float()`` parity) or a short row.
    """
    lib = get_lib()
    if lib is None:
        return None
    path_b = os.fspath(path).encode()
    n_rows = lib.tn_dist_csv_scan(path_b)
    if n_rows < 0:
        return None
    I = np.zeros(max(n_rows, 1), dtype=np.int64)
    J = np.zeros(max(n_rows, 1), dtype=np.int64)
    n_out = np.zeros(4, dtype=np.int64)
    names_cap = 1 << 22
    while True:
        blob = ctypes.create_string_buffer(names_cap)
        rc = lib.tn_read_dist_csv(path_b, col_index, float(threshold), I, J, max(n_rows, 1),
                                  blob, names_cap, n_out)
        if rc == -2 and names_cap < (1 << 30):  # the names outgrew the blob
            names_cap *= 8
            continue
        break
    if rc == -4:
        raise ValueError(f"could not convert distance column {col_index} to float")
    if rc == -3:
        raise ValueError("malformed distance CSV row (too few columns)")
    if rc != 0:
        return None
    n_edges, _n_names, n_rows, blob_len = (int(x) for x in n_out)
    names = ctypes.string_at(blob, blob_len).decode().split("\x00")[:-1] if blob_len else []
    return I[:n_edges], J[:n_edges], names, n_rows


def native_window_stats(pos, seg_bounds, w):
    """Per-SNP windowed (count, span) for the recombination filter: a
    two-pointer sweep per pair segment.  Returns (int32 count, int64 span)
    arrays, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    seg_bounds = np.ascontiguousarray(seg_bounds, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.int64)
    count = np.empty(len(pos), dtype=np.int32)
    span = np.empty(len(pos), dtype=np.int64)
    lib.tn_window_stats(pos, len(pos), seg_bounds, len(seg_bounds) - 1, w, count, span)
    return count, span


def native_filter_windows(pos, seg_bounds, w, tables, tab_off, tab_width, cap):
    """The recombination filter's whole window pass: two-pointer (count,
    span) per SNP with the keep decision read from per-pair boolean tables
    and kept counts summed per pair.  Returns (int64 kept[n_pairs], uint8
    ovf_mark[n_snps]) where marked SNPs had window counts above ``cap``
    (counted as kept; the caller resolves them); None when the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    seg_bounds = np.ascontiguousarray(seg_bounds, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.int64)
    tables = np.ascontiguousarray(tables, dtype=np.uint8)
    tab_off = np.ascontiguousarray(tab_off, dtype=np.int64)
    tab_width = np.ascontiguousarray(tab_width, dtype=np.int64)
    n_pairs = len(seg_bounds) - 1
    kept = np.empty(n_pairs, dtype=np.int64)
    ovf = np.zeros(len(pos), dtype=np.uint8)
    lib.tn_filter_windows(pos, len(pos), seg_bounds, n_pairs, w,
                          tables, tab_off, tab_width, int(cap), kept, ovf)
    return kept, ovf
