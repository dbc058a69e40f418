"""``distance`` stage: pairwise SNP and transmission distances per MSA,
written as the reference CSV (counterpart of tracs_tpu/stages/distance.py).

The CSV schema is ``sampleA,sampleB,date difference,SNP distance,
transmission distance,expected K,filtered SNP distance,sites considered,
MSA file``.  Without ``--meta`` the three transmission columns hold NA and
the filtered column holds 0, byte for byte what ``tracs_tpu`` writes for the
same invocation.  With ``--meta`` (a CSV of sample name and ISO sampling
date) the transmission model (models/transcluster.py) fills them on
``--device``, ``-K`` drops the pairs whose expected K exceeds it, and the
filtered column holds NA.  ``--filter`` runs the recombination filter
(ops/recomb.py): the filtered distance fills its column, also with
``--meta``, where it replaces the raw distance as the model's input.
``--pack-cache DIR`` serves each MSA's packed planes from an on-disk cache
in DIR (ops/packing.py::pack_fasta; off unless given).

Several processes (one card each) share the sweep when ``--mesh`` names a
mesh over them: ``global`` (every rank, shaped by the planner) or ``DPxSP``
(dp·sp must be the number of processes); ``auto``, the default, and ``off``
keep the sweep on this process's card.  A mesh forces streaming (row blocks
of 1024 unless ``--row-block`` says otherwise).  Every process runs the
stage; rank 0 writes the output and rank r > 0 writes the same bytes to
``{output}.proc{r}``.  ``--coordinator``, ``--num-processes`` and
``--process-id`` set up the processes' group first
(parallel/multihost.py::initialize).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from datetime import date

import numpy as np

from tracs_tpu_torch.models.transcluster import (
    SECONDS_IN_YEAR,
    TransClusterCache,
    calculate_trans_prob,
    sample_seconds,
)
from tracs_tpu_torch.ops.packing import pack_fasta
from tracs_tpu_torch.ops.pairsnp import INT32_MAX, pairsnp, pairsnp_stream
from tracs_tpu_torch.parallel import multihost
from tracs_tpu_torch.parallel.mesh import parse_mesh_spec, resolve_mesh, world
from tracs_tpu_torch.runtime.device import resolve_device
from tracs_tpu_torch.runtime.native import native_format_rows
from tracs_tpu_torch.runtime import profiling
from tracs_tpu_torch.runtime.profiling import phase, span
from tracs_tpu_torch.utils import (
    add_loglevel_arg,
    check_positive_float,
    check_positive_int,
    setup_logging,
)

HEADER = (
    "sampleA,sampleB,date difference,SNP distance,transmission distance,"
    "expected K,filtered SNP distance,sites considered,MSA file\n"
)

#: MSAs with more samples than this stream in row blocks even without --row-block
_AUTO_STREAM_SAMPLES = 4096


def distance_parser(parser):
    parser.description = (
        "Estimates pairwise SNP and transmission distances between each pair "
        "of samples aligned to the same reference genome."
    )

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "--msa", dest="msa_files", required=True,
        help="Input fasta files formatted by the align and merge functions",
        type=os.path.abspath, nargs="+",
    )
    io_opts.add_argument(
        "--msa-db", dest="msa_db",
        help="A database MSA used to compare each sequence to. By default "
             "all pairwise comparisons within each MSA are considered.",
        type=os.path.abspath, default=None,
    )
    io_opts.add_argument(
        "--meta", dest="metadata", default=None,
        help="Location of metadata in csv format. The first column must "
             "include the sequence names and the second column must include "
             "sampling dates.",
        type=os.path.abspath,
    )
    io_opts.add_argument(
        "-o", "--output", dest="output_file", required=True,
        help="name of the output file to store the pairwise distance estimates.",
        type=str,
    )

    snpdist = parser.add_argument_group("SNP distance options")
    snpdist.add_argument(
        "-D", "--snp_threshold", dest="snp_threshold",
        help="Only output those transmission pairs with a SNP distance <= D",
        type=check_positive_int, default=INT32_MAX,
    )
    snpdist.add_argument(
        "--filter", dest="recomb_filter",
        help="Filter out regions with unusually high SNP distances often "
             "caused by HGT",
        action="store_true", default=False,
    )

    transdist = parser.add_argument_group("Transmission distance options (used with --meta)")
    transdist.add_argument(
        "--clock_rate", dest="clock_rate", type=check_positive_float,
        default=1e-3 * 29903,
        help="clock rate (SNPs/genome/year) default=1e-3 * 29903",
    )
    transdist.add_argument(
        "--trans_rate", dest="trans_rate", type=check_positive_float, default=73.0,
        help="transmission rate (transmissions/year) default=73",
    )
    transdist.add_argument(
        "-K", "--trans_threshold", dest="trans_threshold", type=check_positive_int,
        default=None,
        help="Only outputs those pairs where the most likely number of "
             "intermediate hosts <= K",
    )
    transdist.add_argument(
        "--precision", dest="precision", type=check_positive_float, default=0.01,
        help="The precision used to calculate E(K) (default=0.01).",
    )

    scale = parser.add_argument_group("Scale options")
    scale.add_argument(
        "--row-block", dest="row_block", type=check_positive_int, default=None,
        help="Stream the all-pairs computation in row blocks of this many "
             "samples (bounds host memory for very large runs and enables "
             "--resume). Default: whole matrix at once.",
    )
    scale.add_argument(
        "--resume", dest="resume", action="store_true", default=False,
        help="Resume an interrupted --row-block run from the cursor file "
             "written next to the output.",
    )
    scale.add_argument(
        "--pack-cache", dest="pack_cache", type=os.path.abspath, default=None,
        help="Directory of an on-disk cache of packed alignments: a rerun on an "
             "unchanged FASTA loads its planes from there instead of parsing it "
             "(default: no cache; nothing is written unless this is given).",
    )
    scale.add_argument(
        "--mesh", dest="mesh", type=str, default=None,
        help="Process mesh for the all-pairs sweep: 'auto' (default: this "
             "process's card), 'off' (one device), 'global' (every process of "
             "a multi-process launch, shaped to the workload) or an explicit "
             "'DPxSP' shape over the processes, e.g. '4x2' = 4 sample shards x "
             "2 genome-position shards. Output is identical for every shape.",
    )
    scale.add_argument(
        "--device", dest="device", choices=["cuda", "cpu"], default="cuda",
        help="Device of the sweep and the transmission model (default: cuda; "
             "fails when no card exists).",
    )

    parser.add_argument(
        "-t", "--threads", dest="n_cpu",
        help="number of threads to use (default=1)",
        type=check_positive_int, default=1,
    )
    multihost.add_launch_args(parser)
    add_loglevel_arg(parser)
    parser.set_defaults(func=distance)
    return parser


def _peek_fasta_dims(path):
    """(n_samples, n_words) of one MSA, to shape a ``global`` mesh: the first
    record is walked line by line for its length, the other headers are
    counted in 16 MB binary chunks.  (None, None) when unreadable: the
    planner then takes its dimension-free default."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    try:
        with opener(path, "rb") as fh:
            n = 0
            length = 0
            for line in fh:
                if line.startswith(b">"):
                    n += 1
                    if n == 2:
                        break
                elif n == 1:
                    length += len(line.rstrip())
            prev_nl = True
            while True:
                chunk = fh.read(1 << 24)
                if not chunk:
                    break
                n += chunk.count(b"\n>")
                if prev_nl and chunk.startswith(b">"):
                    n += 1
                prev_nl = chunk.endswith(b"\n")
    except OSError:
        return None, None
    if n == 0 or length == 0:
        return None, None
    return n, (length + 31) // 32


def _resolve_mesh(args):
    """The mesh of ``--mesh``; ``global`` over several processes is shaped
    to the first MSA's dimensions."""
    n_peek = w_peek = None
    if parse_mesh_spec(args.mesh) == "global" and world()[1] > 1:
        n_peek, w_peek = _peek_fasta_dims(args.msa_files[0])
    return resolve_mesh(args.mesh, n_samples=n_peek, n_words=w_peek)


def _pack(args, path: str):
    """``pack_fasta`` through the cache directory of ``--pack-cache``, if any:
    the flag is the request, so every input is cached whatever its size
    (``pipe``, which shares this namespace, has no such flag)."""
    return pack_fasta(path, cache_dir=getattr(args, "pack_cache", None))


def _ref_name(msa: str) -> str:
    return os.path.basename(msa).split(".")[0].replace("_combined", "")


def _load_dates(path: str) -> dict:
    """``{sample name: (date text, datetime.date)}`` from the --meta CSV
    (header skipped; name and ISO date in the first two columns)."""
    dates = {}
    with open(path) as fh:
        next(fh)
        for line in fh:
            fields = line.strip().split(",")
            dates[fields[0]] = (fields[1], date.fromisoformat(fields[1]))
    return dates


class _PairYears:
    """Date differences in years of emitted pairs of one MSA.  Each
    sample's date is looked up once, at its first emitted pair, so a block
    costs one numpy gather; a sample without a date raises KeyError there,
    as in the reference."""

    def __init__(self, dates: dict, names):
        self.dates, self.names = dates, names
        self.secs = np.zeros(len(names))
        self.known = np.zeros(len(names), dtype=bool)

    def __call__(self, rows, cols):
        needed = np.unique(np.concatenate([rows, cols]))
        for i in needed[~self.known[needed]]:
            self.secs[i] = sample_seconds(self.dates, self.names[i])
            self.known[i] = True
        return np.abs(self.secs[rows] - self.secs[cols]) / SECONDS_IN_YEAR


def _format_rows(names, rows, cols, dvals, filt, nn, ref, trans=None,
                 blob_cache=None) -> str:
    """CSV text of the emitted pairs (native writer, Python if it is absent).
    ``trans`` = (date difference, p0, expected K) fills the transmission
    columns; without it those three columns are NA.  ``filt`` None writes NA
    in the filtered column."""
    if len(rows) == 0:
        return ""
    if trans is None:
        txt = native_format_rows(names, rows, cols, dvals, nn, ref, filt=filt,
                                 blob_cache=blob_cache)
        if txt is None:
            txt = "".join(
                f"{names[i]},{names[j]},NA,{int(d)},NA,NA,{f},{c},{ref}\n"
                for i, j, d, f, c in zip(rows, cols, dvals, filt, nn)
            )
        return txt
    txt = native_format_rows(names, rows, cols, dvals, nn, ref, *trans, filt=filt,
                             blob_cache=blob_cache)
    if txt is None:
        filt = ["NA"] * len(rows) if filt is None else filt
        txt = "".join(
            f"{names[i]},{names[j]},{float(t)},{int(d)},{float(p)},{float(e)},{f},{c},{ref}\n"
            for i, j, d, f, c, t, p, e in zip(rows, cols, dvals, filt, nn, *trans)
        )
    return txt


def _transmission_rows(args, names, rows, cols, dvals, filt, nn, ref, trans,
                       blob_cache=None):
    """CSV text of the pairs that -K keeps (expected K <= K; all without
    -K), with their transmission columns ``trans`` = (years, p0, eK).  The
    filtered column holds ``filt`` on a --filter run and NA otherwise."""
    keep = (np.arange(len(rows)) if args.trans_threshold is None
            else np.nonzero(args.trans_threshold >= trans[2])[0])
    rows, cols, dvals, filt, nn, *trans = (np.asarray(x)[keep]
                                            for x in (rows, cols, dvals, filt, nn, *trans))
    return _format_rows(names, rows, cols, dvals, filt if args.recomb_filter else None,
                        nn, ref, trans, blob_cache)


def distance(args):
    """The stage.  With ``--loglevel DEBUG`` it records the spans of
    runtime/profiling.py and logs their totals and the counters at its end."""
    setup_logging(args.loglevel)
    if not logging.root.isEnabledFor(logging.DEBUG):
        return _distance(args)
    t0 = time.perf_counter()
    profiling.enable()
    try:
        return _distance(args)
    finally:
        profiling.disable()
        profiling.log_summary(profiling.since(t0))


def _distance(args):
    multihost.launch(args)
    device = resolve_device(args.device)
    logging.info("Running the SNP sweep on %s", device)
    dates = _load_dates(args.metadata) if args.metadata is not None else None
    mesh = _resolve_mesh(args)
    if mesh is not None:
        logging.info("Running on a %s mesh", dict(zip(mesh.mesh_dim_names, mesh.shape)))
        args.row_block = args.row_block or 1024
    # every process runs the stage (the collectives need them all); one owns
    # the output path and the others write the same bytes beside it
    rank, n_proc = world()
    if n_proc > 1 and rank > 0:
        args.output_file = f"{args.output_file}.proc{rank}"
        logging.info("process %d writes %s", rank, args.output_file)

    # a cursor file is what an interrupted streaming run leaves behind; one
    # that streamed on its own account (below) used row blocks of 1024
    if args.resume and not args.row_block and os.path.exists(args.output_file + ".cursor"):
        args.row_block = 1024
    if args.row_block:
        return _distance_streaming(args, device, dates, mesh=mesh)

    # one MSA at a time is packed, swept and dropped (pipe hands over one MSA
    # per reference genome); the database side is shared by all of them
    db = _pack(args, args.msa_db) if args.msa_db is not None else None
    large = None  # (index, packed alignment) of the first MSA that must stream
    with open(args.output_file, "w") as outfile:
        outfile.write(HEADER)
        for mi, msa in enumerate(args.msa_files):
            a = _pack(args, msa)
            if a.n_seqs > _AUTO_STREAM_SAMPLES:
                large = (mi, a)
                break
            logging.info("Calculating pairwise snp distances for %s", msa)
            rows, cols, dvals, names, filt, nn = pairsnp(
                [a, db] if db is not None else [a],
                n_threads=args.n_cpu, dist=args.snp_threshold,
                filter=args.recomb_filter, device=device,
            )
            ref = _ref_name(msa)
            logging.info("Saving distances for %s", msa)
            if dates is None or len(rows) == 0:
                outfile.write(_format_rows(names, rows, cols, dvals, filt, nn, ref))
                continue
            logging.info("Inferring transmission probabilities for %s", msa)
            # with --filter the filtered distance is the model's input
            p0, eK, years = calculate_trans_prob(
                [rows, cols, filt if args.recomb_filter else dvals], dates, K=100,
                lamb=args.clock_rate,
                beta=args.trans_rate, samplenames=names, precision=args.precision,
                device=device,
            )
            outfile.write(_transmission_rows(args, names, rows, cols, dvals, filt, nn,
                                             ref, (years, p0, eK)))
    if large is not None:
        # a large input streams from here on (bounded host memory, resumable);
        # its sample count came from the packed alignment, which is reused
        logging.info(
            "%s samples detected: switching to streaming row blocks "
            "(use --row-block to control the block size)", large[1].n_seqs,
        )
        args.row_block = 1024
        _distance_streaming(args, device, dates, *large, db)


def _distance_streaming(args, device, dates, first_msa=0, first_packed=None, db=None,
                        mesh=None):
    """Row-block streaming driver: bounded host memory, incremental CSV
    writes, and a cursor file so an interrupted sweep resumes at the last
    completed block.  The cursor records the flushed byte offset after each
    block; a resumed run truncates the output there first, so it is
    byte-identical to an uninterrupted one.  With ``dates`` one
    TransClusterCache serves every block of the run.  Output rows are
    identical to the non-streaming path.  With ``first_packed``, the
    packed alignment of MSA ``first_msa``, the run continues an output that
    holds the header and every earlier MSA already.  ``mesh`` runs the
    sweep over the processes of a mesh (``pairsnp_stream``).  The call is
    one run of runtime/profiling.py; each block's tail is the span
    ``stage.tail`` (``phase``), holding ``stage.format`` (the CSV text) and
    ``stage.write`` (write, flush and cursor)."""
    profiling.count("stage.runs")
    with profiling.run():
        _stream_msas(args, device, dates, first_msa, first_packed, db, mesh)


def _stream_msas(args, device, dates, first_msa, first_packed, db, mesh):
    cursor_path = args.output_file + ".cursor"
    cursor = {"msa_index": first_msa, "next_row": 0}
    mode = "w" if first_packed is None else "a"
    if first_packed is None and args.resume and os.path.exists(cursor_path):
        with open(cursor_path) as fh:
            cursor = json.load(fh)
        mode = "a"
        logging.info("Resuming from %s", cursor)
        if "bytes" in cursor and os.path.exists(args.output_file):
            with open(args.output_file, "r+") as fh:
                fh.truncate(cursor["bytes"])
    cache = None
    if dates is not None:
        cache = TransClusterCache(args.clock_rate, args.trans_rate, args.precision,
                                  device=device)

    with open(args.output_file, mode) as outfile:
        if mode == "w":
            outfile.write(HEADER)
        for mi, msa in enumerate(args.msa_files):
            if mi < cursor["msa_index"]:
                continue
            start_row = cursor["next_row"] if mi == cursor["msa_index"] else 0
            ref = _ref_name(msa)
            a = first_packed if mi == first_msa and first_packed is not None else _pack(args, msa)
            first_packed = None  # one packed MSA is held at a time
            if db is None and args.msa_db is not None:
                db = _pack(args, args.msa_db)
            logging.info("Streaming pairwise distances for %s", msa)
            debug = logging.root.isEnabledFor(logging.DEBUG)
            t_msa, pairs0 = time.perf_counter(), profiling.counter("sweep.pairs")
            blob_cache = {}  # per MSA: the names blob is shared across blocks
            years_of = None  # per MSA: its samples' dates, filled lazily
            for r0, r1, names, rows, cols, dvals, filt, nn in pairsnp_stream(
                [a, db] if db is not None else [a], dist=args.snp_threshold,
                filter=args.recomb_filter, row_block=args.row_block,
                start_row=start_row, device=device, mesh=mesh,
            ):
                with phase("block rows [%d,%d)" % (r0, r1), device):
                    if cache is None or len(rows) == 0:
                        with span("stage.format"):
                            txt = _format_rows(names, rows, cols, dvals, filt, nn, ref,
                                               blob_cache=blob_cache)
                    else:
                        if years_of is None:
                            years_of = _PairYears(dates, names)
                        years = years_of(rows, cols)
                        log_p0, eK = cache.lookup(filt if args.recomb_filter else dvals,
                                                  years)
                        with span("stage.format"):
                            txt = _transmission_rows(args, names, rows, cols, dvals, filt, nn,
                                                     ref, (years, np.exp(log_p0), eK),
                                                     blob_cache)
                    with span("stage.write"):
                        outfile.write(txt)
                        outfile.flush()
                        # atomic cursor update: a kill mid-write leaves the old one
                        state = {"msa_index": mi, "next_row": r1, "bytes": outfile.tell()}
                        with open(cursor_path + ".tmp", "w") as fh:
                            json.dump(state, fh)
                        os.replace(cursor_path + ".tmp", cursor_path)
                if debug:
                    done = profiling.counter("sweep.pairs") - pairs0
                    dt = max(time.perf_counter() - t_msa, 1e-9)
                    logging.debug("[rate] %s pairs in %.1fs (%.0f pairs/s)", f"{done:,}", dt,
                                  done / dt)
            cursor = {"msa_index": mi + 1, "next_row": 0}
    if os.path.exists(cursor_path):
        os.remove(cursor_path)
    logging.info("Streaming distance run complete.")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser = distance_parser(parser)
    args = parser.parse_args(argv)
    args.func(args)
