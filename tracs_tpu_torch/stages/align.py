"""``align`` stage: per-sample reference selection, read alignment, and
coverage-aware posterior allele calling (counterpart of
tracs_tpu/stages/align.py).

  (a) reference selection by gather against a database zip (the native
      FracMinHash gather of sketch.py, or sourmash), or a single
      ``--refseqs`` fasta;
  (b) a bare assembly is shredded into pseudo-reads;
  (c) per-reference minimap2/samtools/htsbox alignment + pileup
      (io/external.py), or one composite pass with ``--composite``;
  (d) pileup -> [L, 4] count matrix (native parser, io/pileup.py);
  (e) coverage statistics and skip rules (< 25% covered);
  (f) consensus mode: argmax one-hot with low-coverage rows -> N;
  (g) Dirichlet-multinomial prior fit and posterior thresholding on
      ``--device`` (models/dirichlet.py): the count matrix goes to the device
      once per reference and the posteriors come back once;
  (h) coverage-outlier masking from the alphas and the coverage quartiles;
  (i) posterior-count csv.gz and a one-record IUPAC fasta through the
      little-endian nibble table (skipped if > 75% N).

The Genbank download needs the optional ``ncbi_genome_download`` package and
a network; without them it raises and steers the user to a database zip or a
``--refseqs`` folder.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import logging
import os
import shutil
import sys
import tempfile
from collections import Counter
from zipfile import ZipFile

import numpy as np
import torch

from tracs_tpu_torch.io.external import (
    align_and_pileup,
    align_and_pileup_composite,
    generate_reads,
    run_gather,
)
from tracs_tpu_torch.io.fasta import read_fasta
from tracs_tpu_torch.io.pileup import parse_pileup
from tracs_tpu_torch.models.dirichlet import find_dirichlet_priors, posteriors_on_device
from tracs_tpu_torch.ops.packing import nibbles_to_string
from tracs_tpu_torch.runtime.device import resolve_device, to_host
from tracs_tpu_torch.sketch import load_db_sketches, native_gather
from tracs_tpu_torch.utils import add_loglevel_arg, setup_logging


def align_parser(parser):
    parser.description = (
        "Uses sourmash to identify reference genomes within a read set and "
        "then aligns reads to each reference using minimap2"
    )

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "-i", "--input", dest="input_files", required=True,
        help="path to query signature", type=os.path.abspath, nargs="+",
    )
    io_opts.add_argument(
        "--database", dest="database",
        help="path to database signatures", type=os.path.abspath, default=None,
    )
    io_opts.add_argument(
        "--refseqs", dest="refseqs",
        help="path to reference fasta files", type=os.path.abspath, default=None,
    )
    io_opts.add_argument(
        "-o", "--output", dest="output_dir", required=True,
        help="location of an output directory", type=os.path.abspath,
    )
    io_opts.add_argument(
        "-p", "--prefix", dest="prefix", default=None,
        help="prefix to describe the input sample read files", type=str,
    )

    alignment = parser.add_argument_group("Alignment options")
    alignment.add_argument(
        "--minimap_preset", dest="minimap_preset",
        help="minimap preset to use - one of 'sr' (default), 'map-ont' or 'map-pb'",
        default="sr", type=str,
    )
    alignment.add_argument(
        "--composite", dest="composite",
        help="align reads ONCE against a composite of all selected references "
             "and split the pileup per reference (faster for metagenomic "
             "samples hitting many references)",
        action="store_true", default=False,
    )

    pileup = parser.add_argument_group("Pileup options")
    pileup.add_argument("-Q", "--min_base_qual", dest="min_base_qual",
                        help="minimum base quality (default=0)", type=int, default=0)
    pileup.add_argument("-q", "--min_map_qual", dest="min_map_qual",
                        help="minimum mapping quality (default=0)", type=int, default=0)
    pileup.add_argument("-l", "--min_query_len", dest="min_query_len",
                        help="minimum query length (default=0)", type=int, default=0)
    pileup.add_argument("-V", "--max_div", dest="max_div",
                        help="ignore queries with per-base divergence > max_div (default=1)",
                        type=float, default=1)
    pileup.add_argument("--trim", dest="trim",
                        help="ignore bases within TRIM-bp from either end of a read (default=0)",
                        type=int, default=0)

    posterior = parser.add_argument_group("Posterior count estimates")
    posterior.add_argument(
        "--consensus", dest="consensus",
        help="Turns on consensus mode. Only the most common allele at each "
             "site will be reported and all other filters will be ignored.",
        action="store_true", default=False,
    )
    posterior.add_argument("--min-cov", dest="min_cov", default=5,
                           help="Minimum read coverage (default=5).", type=int)
    posterior.add_argument(
        "--keep-cov-outliers", dest="keep_cov_outliers",
        help="Turns off filtering of genome regions with unusual coverage. "
             "Useful if no gene gain/loss is expected.",
        action="store_true", default=False,
    )
    posterior.add_argument(
        "--error-perc", dest="error_threshold", default=0.01,
        help="Threshold to exclude likely erroneous variants.", type=float,
    )
    posterior.add_argument(
        "--either-strand", dest="require_both_strands",
        help="turns off the requirement that a variant is supported by both strands",
        action="store_false", default=True,
    )
    posterior.add_argument(
        "--keep-all", dest="keep_all",
        help="turns on keeping of variants with support below the posterior "
             "frequency threshold",
        action="store_true", default=False,
    )

    parser.add_argument(
        "--device", dest="device", choices=["cuda", "cpu"], default="cuda",
        help="Device of the Dirichlet-multinomial fit and the posteriors "
             "(default: cuda; fails when no card exists).",
    )
    parser.add_argument("-t", "--threads", dest="n_cpu",
                        help="number of threads to use (default=1)", type=int, default=1)
    add_loglevel_arg(parser)
    parser.set_defaults(func=align)
    return parser


def fetch_genbank_assembly(accession: str, outdir: str) -> str:
    """Download one assembly by accession into ``outdir`` and return the
    fasta path.  Tries the Genbank section first, then RefSeq.  The
    downloader package is optional: without it this raises."""
    try:
        import ncbi_genome_download as ngd
    except ImportError as e:
        raise RuntimeError(
            "Automatic Genbank reference download requires the "
            "ncbi_genome_download package, which is not available in this "
            "environment. Build a database zip with 'build-db' or pass "
            "--refseqs with a local genome folder instead."
        ) from e
    for section in ("genbank", "refseq"):
        status = ngd.download(
            groups="bacteria", section=section, file_formats="fasta",
            flat_output=True, output=outdir, assembly_accessions=accession,
        )
        if status == 0:
            return glob.glob(os.path.join(outdir, "*fna.gz"))[0]
    raise ValueError("Could not download reference for: ", accession)


def gtdb_fasta_path(root_dir: str, accession: str) -> str:
    """Resolve an accession inside a GTDB-style genome folder, which nests
    genomes by accession segments (GCA_000123456 ->
    GCA/000/123/456/*.fna.gz)."""
    segments = (accession[:3], accession[4:7], accession[7:10], accession[10:13])
    nested = os.path.join(root_dir, *segments)
    for path in glob.glob(os.path.join(nested, "*.fna.gz")):
        return path
    raise ValueError("Could not find reference for: ", accession)


# the original pipeline's names of the two helpers
download_ref = fetch_genbank_assembly
find_fasta = gtdb_fasta_path


def nibble_sequence(mask01: np.ndarray) -> str:
    """[L, 4] 0/1 allele-presence -> IUPAC string via the little-endian
    nibble (bit 0 = A .. bit 3 = T; no allele at all gives 'X')."""
    nib = (
        mask01[:, 0].astype(np.uint8)
        | (mask01[:, 1].astype(np.uint8) << 1)
        | (mask01[:, 2].astype(np.uint8) << 2)
        | (mask01[:, 3].astype(np.uint8) << 3)
    )
    return nibbles_to_string(nib)


def _gather_reference_names(args, temp_dir: str) -> list[str]:
    """Run reference selection (gather) against the database and return the
    selected names.  Prefers the native FracMinHash gather whenever the db
    zip carries no SBT, or carries native sketches and sourmash is absent;
    otherwise shells out to sourmash gather against the (possibly embedded)
    SBT index."""
    is_bare_sbt = ".sbt.zip" in args.database
    if not is_bare_sbt:
        with ZipFile(args.database) as archive:
            has_sbt = "sourmashDB.sbt.zip" in archive.namelist()
        sourmash_available = shutil.which("sourmash") is not None
        if not has_sbt or (not sourmash_available and load_db_sketches(args.database)):
            logging.info("Selecting references with the native FracMinHash gather")
            return native_gather(
                args.input_files,
                args.database,
                args.output_dir + args.prefix + "_sourmash_hits.csv",
            )

    if is_bare_sbt:
        sbt = args.database
    else:
        with ZipFile(args.database) as archive:
            archive.extract("sourmashDB.sbt.zip", temp_dir)
        sbt = temp_dir + "sourmashDB.sbt.zip"
    return run_gather(
        input_files=args.input_files,
        databasefile=sbt,
        output=args.output_dir + args.prefix + "_sourmash_hits",
        temp_dir=temp_dir,
    )


def _locate_accession(args, accession: str) -> str:
    """Fasta path for one selected accession when the database zip carries
    no genomes (bare SBT): a GTDB-style --refseqs folder if given, else a
    cached-or-fresh Genbank download under genbank_references/."""
    if args.refseqs is not None:
        return gtdb_fasta_path(args.refseqs, accession)
    cache_dir = args.output_dir + "genbank_references/" + accession + "/"
    if os.path.exists(cache_dir):
        logging.info("Reference already downloaded: %s", accession)
        return glob.glob(cache_dir + "*.fna.gz")[0]
    os.makedirs(cache_dir)
    return fetch_genbank_assembly(accession, cache_dir)


def select_references(args, temp_dir: str) -> dict[str, str]:
    """{reference name: fasta path} from whichever source the CLI gave:

    * ``--refseqs <fasta>`` with no database — that one genome;
    * a build-db zip — gather (native or sourmash), genomes extracted
      straight from the zip;
    * a bare ``.sbt.zip`` — sourmash gather, genomes resolved from a GTDB
      folder or downloaded from Genbank.
    """
    if args.database is None:
        name = os.path.splitext(os.path.basename(args.refseqs))[0]
        return {name: args.refseqs}

    selected = _gather_reference_names(args, temp_dir)

    if ".sbt.zip" in args.database:
        logging.warning(
            "No references provided. tracs_tpu_torch will attempt to locate or "
            "download references"
        )
        accessions = [name.split()[0].strip('"') for name in selected]
        logging.debug("%s", accessions)
        return {acc: _locate_accession(args, acc) for acc in accessions}

    with ZipFile(args.database) as archive:
        for ref in selected:
            archive.extract(ref + ".fasta.gz", temp_dir)
    return {ref: temp_dir + ref + ".fasta.gz" for ref in selected}


def _resolve_reads(args, temp_dir: str):
    """(r1, r2) read files for the aligner; a single bare assembly fasta is
    shredded into pseudo-reads first."""
    if len(args.input_files) == 2:
        return args.input_files[0], args.input_files[1]
    (single,) = args.input_files
    if os.path.splitext(single)[1] in (".fasta", ".fa"):
        shredded = temp_dir + "simulated_" + os.path.basename(single) + ".gz"
        generate_reads(single, shredded)
        return shredded, None
    return single, None


def align(args):
    setup_logging(args.loglevel)
    args.device = resolve_device(args.device)  # no card: fail before any work

    if args.database is None and args.refseqs is None:
        logging.error("Must provide either a database or reference sequences!")
        sys.exit(1)
    if args.database is not None and ".zip" not in args.database:
        logging.error("Database must be a zip file!")
        sys.exit(1)
    if args.database is None and args.refseqs is not None:
        if ".fna" not in args.refseqs and ".fasta" not in args.refseqs:
            logging.error(
                "Reference sequences must be a fasta file if not using a database!"
            )
            sys.exit(1)

    os.makedirs(args.output_dir, exist_ok=True)
    args.output_dir = os.path.join(args.output_dir, "")
    if args.refseqs is not None and args.database is not None:
        # with a database, --refseqs is a GTDB-style genome FOLDER
        args.refseqs = os.path.join(args.refseqs, "")
    temp_dir = os.path.join(tempfile.mkdtemp(dir=args.output_dir), "")

    if args.prefix is None:
        args.prefix = os.path.splitext(os.path.basename(args.input_files[0]))[0]

    ref_locs = select_references(args, temp_dir)
    references = list(ref_locs)
    r1, r2 = _resolve_reads(args, temp_dir)

    # one aligner pass against a composite of all references, or one pass a
    # reference; the composite pass has no divergence filter (max_div)
    pileup_opts = dict(
        r2=r2, aligner="minimap2", minimap_preset=args.minimap_preset, minimap_params=None,
        Q=args.min_base_qual, q=args.min_map_qual, l=args.min_query_len, T=args.trim,
        n_cpu=args.n_cpu,
    )
    if getattr(args, "composite", False):
        align_and_pileup_composite(ref_locs, temp_dir, args.output_dir + args.prefix, r1,
                                   V=args.max_div, **pileup_opts)
    else:
        for ref in references:
            align_and_pileup(ref_locs[ref], temp_dir,
                             args.output_dir + args.prefix + "_ref_" + str(ref), r1,
                             V=1, max_div=args.max_div, **pileup_opts)

    for ref in references:
        logging.info("Analysing reference: %s", ref)
        process_reference(args, ref, ref_locs[ref])

    shutil.rmtree(temp_dir)
    logging.info("Successfully completed align!")
    return


def distinct_values(post: torch.Tensor):
    """(values [U] float64 ascending, index [R, K] int32), numpy, with
    ``post == values[index]``.  A genome's posteriors take few distinct
    values (a handful of depths and ranks): they are found where ``post``
    lies (``torch.unique``: a sort of R x K numbers), and what crosses to the
    host is the index, half the matrix's size, and the few values."""
    values, index = torch.unique(post, return_inverse=True)
    return to_host(values), to_host(index.to(torch.int32))


def write_posterior_csv(path: str, values: np.ndarray, index: np.ndarray) -> None:
    """The matrix ``values[index]`` [R, K] as gzip-compressed CSV text with
    five decimals and a closing empty line: the text of
    ``np.savetxt(fmt="%0.5f", delimiter=",")``.

    Each distinct value is formatted once and the rows are put together as
    bytes; ``np.savetxt`` formats millions of rows one by one.  Posteriors lie
    in [0, 1], so every text is 7 bytes wide; anything else is refused.
    Compression level 3: on such text (2,000,000 rows of some 40 distinct
    values) level 6 takes twice as long for a file 18% smaller."""
    texts = [b"%0.5f" % v for v in values.tolist()]
    width = 7
    if index.ndim != 2 or any(len(t) != width for t in texts):
        raise ValueError("posteriors are a matrix of values in [0, 1]")
    n_rows, n_cols = index.shape
    table = np.frombuffer(b"".join(texts), dtype=np.uint8).reshape(len(texts), width)
    rows = np.empty((n_rows, n_cols, width + 1), dtype=np.uint8)
    rows[:, :, :width] = table[index]  # [R, K, width]
    rows[:, :, width] = ord(",")
    rows[:, -1, width] = ord("\n")
    with gzip.open(path, "wb", compresslevel=3) as outfile:
        outfile.write(rows.tobytes())
        outfile.write(b"\n")


def process_reference(args, ref, ref_loc):
    """Posterior calling for one reference from its pileup file: the
    numerical core of the align stage.  The statistics of the coverage stay
    on the host; the count matrix goes to ``args.device`` once, for the fit
    and the posteriors."""
    contig_lengths = {name: len(seq) for name, seq in read_fasta(ref_loc)}
    pileup_path = args.output_dir + args.prefix + "_ref_" + str(ref) + "_pileup.txt.gz"
    all_counts = parse_pileup(
        pileup_path, contig_lengths, require_both_strands=args.require_both_strands
    )

    rs = np.sum(all_counts, 1)
    nz_cov = np.sum(all_counts[rs > 0,], 1)
    total_cov = np.sum(rs > 0) / all_counts.shape[0]
    median_cov = np.median(nz_cov) if nz_cov.size else 0.0

    out_fasta = (
        args.output_dir + args.prefix + "_posterior_counts_ref_" + str(ref) + ".fasta"
    )

    if args.consensus:
        logging.info("Consensus requested. Skipping all coverage filters!")
        all_counts_01 = np.zeros_like(all_counts, dtype=int)
        max_indices = np.argmax(all_counts, axis=1)
        all_counts_01[np.arange(all_counts.shape[0]), max_indices] = 1
        all_counts_01[rs < args.min_cov,] = 1
        sequence = nibble_sequence(all_counts_01 > 0)
        logging.info("allelecount: %s", Counter(sequence))

        if sequence.count("N") / float(len(sequence)) > 0.75:
            logging.info(
                "Skipping reference: %s as less than 25%% of the genome has "
                "sufficient read coverage.", ref,
            )
            return
        with open(out_fasta, "w") as outfile:
            outfile.write(">" + args.prefix + "_" + str(ref) + "\n")
            outfile.write(sequence + "\n")
        return

    expected_freq_threshold = max(args.min_cov / median_cov, args.error_threshold) if median_cov else 1.0
    total_cov_min_threshold = np.sum(rs >= args.min_cov) / all_counts.shape[0]

    logging.info("Fraction of genome with read coverage: %s", total_cov)
    logging.info(
        "Fraction of genome with read coverage >= %s: %s",
        args.min_cov, total_cov_min_threshold,
    )
    logging.info("Median non-zero coverage: %s", median_cov)

    if total_cov_min_threshold < 0.25:
        logging.info(
            "Skipping reference: %s as less than 25%% of the genome has "
            "sufficient read coverage.", ref,
        )
        return

    counts_dev = torch.from_numpy(all_counts).to(args.device)
    alphas = find_dirichlet_priors(
        counts_dev, method="FPI", error_filt_threshold=args.error_threshold,
        device=args.device,
    )
    logging.info("Calculated alphas: %s", alphas)

    if expected_freq_threshold <= alphas[1] / (median_cov + np.sum(alphas)):
        expected_freq_threshold = alphas[1] / (median_cov + np.sum(alphas)) + 0.01
        logging.warning(
            "WARNING: Frequency threshold is set too low! The majority of the "
            "genome will be called as ambiguous."
        )
        logging.warning(
            "WARNING: The threshold has been automatically increased to: %s",
            expected_freq_threshold,
        )

    # coverage-outlier band (gene gain/loss guard)
    cov_filter_threshold = 50
    bad_cov_lower_bound = bad_cov_upper_bound = None
    if not args.keep_cov_outliers:
        if (median_cov > cov_filter_threshold) and (
            alphas[1] / np.sum(alphas) > expected_freq_threshold
        ):
            bad_cov_lower_bound = alphas[1] / expected_freq_threshold - np.sum(alphas)
            lq = np.quantile(nz_cov, [0.25, 0.5])
            bad_cov_upper_bound = lq[0] - 1.5 * (lq[1] - lq[0])
            if bad_cov_lower_bound < bad_cov_upper_bound:
                logging.info("Lower coverage bound: %s", bad_cov_lower_bound)
                logging.info("Upper coverage bound: %s", bad_cov_upper_bound)

    logging.info("Using frequency threshold: %s", expected_freq_threshold)
    logging.info("Calculating posterior frequency estimates...")
    logging.info(
        "Filtering sites with posterior estimates below frequency threshold: %s",
        expected_freq_threshold,
    )
    if args.keep_all:
        logging.info("Keeping all observed alleles")

    post = posteriors_on_device(
        counts_dev, alphas, args.keep_all, expected_freq_threshold, device=args.device
    )
    del counts_dev
    values, index = distinct_values(post)  # the one copy back to the host
    del post
    all_counts = values[index]

    logging.info("saving to file...")
    write_posterior_csv(
        args.output_dir + args.prefix + "_posterior_counts_ref_" + str(ref) + ".csv.gz",
        values, index,
    )
    del index

    if bad_cov_lower_bound is not None:
        logging.info(
            "Fraction of genome filtered by coverage: %s",
            np.sum((rs < bad_cov_upper_bound) & (rs > bad_cov_lower_bound)) / len(rs),
        )
        if bad_cov_upper_bound > bad_cov_lower_bound:
            all_counts[(rs <= bad_cov_upper_bound) & (rs >= bad_cov_lower_bound),] = 1
    all_counts[rs < args.min_cov,] = 1

    sequence = nibble_sequence(all_counts > 0)
    logging.info("allelecount: %s", Counter(sequence))

    if sequence.count("N") / float(len(sequence)) > 0.75:
        logging.info(
            "Skipping reference: %s as greater than 75%% of the genome has "
            "completely ambiguous (N) base calls!", ref,
        )
        return

    with open(out_fasta, "w") as outfile:
        outfile.write(">" + args.prefix + "_" + str(ref) + "\n")
        outfile.write(sequence + "\n")
    return


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser = align_parser(parser)
    args = parser.parse_args(argv)
    args.func(args)
