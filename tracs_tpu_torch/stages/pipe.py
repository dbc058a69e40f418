"""``pipe`` orchestrator: align per sample -> combine -> distance -> cluster
(counterpart of tracs_tpu/stages/pipe.py).

Validates the input TSV (``prefix read1 [read2]``), runs align per sample
into ``outdir/<prefix>/``, concatenates the per-reference FASTAs present in
more than one sample into ``combined<REF>``, then runs distance
(transmission_distances.csv) and cluster (transmission_clusters.csv) over the
shared args namespace.  ``--device`` goes to both align and distance.

Several processes (``--coordinator``, ``--num-processes``, ``--process-id``,
one card each) share the ingest: process r aligns the samples ``i`` with
``i % world == r`` (a shared filesystem, as a cluster's).  All meet at a
barrier; rank 0 then runs combine, distance and cluster on its own card while
the others wait at a second barrier, so that none leaves before the run's
outputs exist.  ``--mesh`` is handed to ``distance``; under several
processes it must keep the sweep on rank 0's card (``off`` or ``auto``),
since the other ranks are not in the tail to join a mesh.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import re
from collections import defaultdict

from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import torch.distributed as dist

from tracs_tpu_torch.ops.pairsnp import INT32_MAX
from tracs_tpu_torch.parallel import multihost
from tracs_tpu_torch.parallel.mesh import check_world, parse_mesh_spec, world
from tracs_tpu_torch.runtime.device import resolve_device
from tracs_tpu_torch.stages.align import align
from tracs_tpu_torch.stages.cluster import cluster
from tracs_tpu_torch.stages.distance import distance
from tracs_tpu_torch.utils import (
    add_loglevel_arg,
    check_positive_float,
    check_positive_int,
    setup_logging,
)


def pipe_parser(parser):
    parser.description = "A script to run the full pipeline."

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "-i", "--input", dest="input_file", required=True,
        help="path to text file containing input file paths", type=os.path.abspath,
    )
    io_opts.add_argument(
        "--database", dest="database", required=True,
        help="path to database signatures", type=os.path.abspath,
    )
    io_opts.add_argument(
        "--refseqs", dest="refseqs", default=None,
        help="path to reference fasta files", type=os.path.abspath,
    )
    io_opts.add_argument(
        "-o", "--output", dest="output_dir", required=True,
        help="location of an output directory", type=os.path.abspath,
    )
    io_opts.add_argument(
        "--meta", dest="metadata", default=None,
        help="Location of metadata in csv format. The first column must "
             "include the sequence names and the second column must include "
             "sampling dates.",
        type=os.path.abspath,
    )

    alignment = parser.add_argument_group("Alignment options")
    alignment.add_argument(
        "--minimap_preset", dest="minimap_preset", default="sr", type=str,
        help="minimap preset to use - one of 'sr' (default), 'map-ont' or 'map-pb'",
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
    posterior.add_argument("--consensus", dest="consensus", action="store_true",
                           default=False,
                           help="Turns on consensus mode. Only the most common allele at "
                                "each site will be reported and all other filters will be ignored.")
    posterior.add_argument("--min-cov", dest="min_cov", default=5, type=int,
                           help="Minimum read coverage (default=5).")
    posterior.add_argument("--keep-cov-outliers", dest="keep_cov_outliers",
                           action="store_true", default=False,
                           help="Turns off filtering of genome regions with unusual coverage.")
    posterior.add_argument("--error-perc", dest="error_threshold", default=0.01,
                           type=float,
                           help="Threshold to exclude likely erroneous variants prior to "
                                "fitting Dirichlet multinomial model")
    posterior.add_argument("--either-strand", dest="require_both_strands",
                           action="store_false", default=True,
                           help="turns off the requirement that a variant is supported by "
                                "both strands")
    posterior.add_argument("--keep-all", dest="keep_all", action="store_true",
                           default=False,
                           help="turns on keeping of variants with support below the "
                                "posterior frequency threshold")

    snpdist = parser.add_argument_group("SNP distance options")
    snpdist.add_argument("-D", "--snp_threshold", dest="snp_threshold",
                         type=check_positive_int, default=INT32_MAX,
                         help="Only output those transmission pairs with a SNP distance <= D")
    snpdist.add_argument("--filter", dest="recomb_filter", action="store_true",
                         default=False,
                         help="Filter out regions with unusually high SNP distances often "
                              "caused by HGT")

    transdist = parser.add_argument_group("Transmission distance options")
    transdist.add_argument("--clock_rate", dest="clock_rate",
                           type=check_positive_float, default=1e-3 * 29903,
                           help="clock rate as defined in the transcluster paper "
                                "(SNPs/genome/year) default=1e-3 * 29903")
    transdist.add_argument("--trans_rate", dest="trans_rate",
                           type=check_positive_float, default=73.0,
                           help="transmission rate as defined in the transcluster paper "
                                "(transmissions/year) default=73")
    transdist.add_argument("-K", "--trans_threshold", dest="trans_threshold",
                           type=check_positive_int, default=None,
                           help="Only outputs those pairs where the most likely number of "
                                "intermediate hosts <= K")
    transdist.add_argument("--precision", dest="precision",
                           type=check_positive_float, default=0.01,
                           help="The precision used to calculate E(K) (default=0.01).")

    cluster_opts = parser.add_argument_group("Cluster options")
    cluster_opts.add_argument("-c", "--cluster_threshold", dest="threshold",
                              type=float, default=10,
                              help="Distance threshold. Samples will be grouped together "
                                   "if the distance between them is below this threshold. "
                                   "(default=10)")
    cluster_opts.add_argument("--cluster_distance", dest="distance",
                              choices=["snp", "filter", "direct", "expectedK"],
                              type=str, default="snp",
                              help="The type of transmission distance to use. Can be one "
                                   "of 'snp' (default), 'filter', 'direct', 'expectedK'")

    scale = parser.add_argument_group("Scale options")
    scale.add_argument(
        "--align-workers", dest="align_workers", type=check_positive_int,
        default=1,
        help="number of samples to ingest (align) concurrently on this host "
             "(default=1; the aligner subprocesses dominate, so workers "
             "multiply throughput until CPU cores saturate)",
    )
    scale.add_argument(
        "--mesh", dest="mesh", type=str, default=None,
        help="process mesh for the distance stage (see tracs-tpu-torch distance "
             "--help); under several processes 'off' or 'auto', since the "
             "distance stage runs on rank 0 alone",
    )
    scale.add_argument(
        "--device", dest="device", choices=["cuda", "cpu"], default="cuda",
        help="Device of the align stage's model and the distance stage's sweep "
             "(default: cuda; fails when no card exists).",
    )

    parser.add_argument("-t", "--threads", dest="n_cpu",
                        help="number of threads to use (default=1)", type=int, default=1)
    multihost.add_launch_args(parser)
    add_loglevel_arg(parser)
    parser.set_defaults(func=pipe)
    return parser


def _validated_samples(input_file: str) -> list[list[str]]:
    """Rows of the input TSV (``prefix read1 [read2]``), validated: unique
    prefixes, every read path an existing file."""
    rows = []
    prefixes = set()
    with open(input_file, "r") as infile:
        next(infile)
        for line in infile:
            line = line.strip().split()
            if not line:
                continue
            if line[0] in prefixes:
                raise ValueError("Repeated file name! " + line[0])
            prefixes.add(line[0])
            if not os.path.isfile(line[1]):
                raise ValueError("Path does not exist or is not a file! " + line[1])
            if (len(line) > 2) and not os.path.isfile(line[2]):
                raise ValueError("Path does not exist or is not a file! " + line[2])
            rows.append(line)
    return rows


def _ingest_samples(args, outputdir: str, rows: list[list[str]]) -> None:
    """Per-sample align.  ``--align-workers`` samples run concurrently in a
    thread pool: the aligner subprocesses (minimap2 | samtools | htsbox)
    dominate a sample's time and release the interpreter lock.  The threads
    share one CUDA device and PyTorch's default stream, so their Dirichlet
    fits and posterior passes run on the card one after the other, in
    whatever order the threads reach it; each works on its own tensors, so
    the results are those of a serial run."""
    def align_one(row):
        sample_args = argparse.Namespace(**vars(args))
        sample_args.input_files = row[1:]
        sample_args.prefix = row[0]
        sample_args.output_dir = outputdir + row[0]
        align(sample_args)

    workers = max(1, min(getattr(args, "align_workers", 1), len(rows) or 1))
    if workers == 1:
        for row in rows:
            align_one(row)
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            # list() propagates the first worker exception
            list(pool.map(align_one, rows))


#: how long a rank waits at pipe's barriers: for the slowest rank's ingest,
#: then for rank 0's combine, distance and cluster, which take as long as
#: the data needs
_BARRIER_TIMEOUT = timedelta(days=7)


def _check_mesh(spec) -> None:
    """Raises, before any work, for a ``--mesh`` that the distance stage
    would refuse (a shape whose size is not the world's) or that the other
    ranks could not join (a mesh over several processes: only rank 0 runs
    the distance stage)."""
    parsed = parse_mesh_spec(spec)
    if isinstance(parsed, tuple) and parsed[0] * parsed[1] > 1:
        check_world(*parsed)
    if world()[1] > 1 and parsed not in ("off", "auto"):
        raise ValueError(
            f"pipe --mesh {spec}: under several processes pipe runs distance on rank 0 "
            "alone; use --mesh off or auto, or run the distance stage on every process")


def pipe(args):
    setup_logging(args.loglevel)
    args.device = resolve_device(args.device)  # no card: fail before any work
    multihost.launch(args)
    _check_mesh(args.mesh)
    rank, n_proc = world()
    # a group of its own for the barriers, with a timeout that the tail fits
    barrier = dist.new_group(backend="gloo", timeout=_BARRIER_TIMEOUT) if n_proc > 1 else None

    try:
        os.mkdir(args.output_dir)
    except FileExistsError:
        pass
    args.output_dir = os.path.join(args.output_dir, "")
    outputdir = args.output_dir

    rows = _validated_samples(args.input_file)
    prefixes = {row[0] for row in rows}

    mine = [row for i, row in enumerate(rows) if i % n_proc == rank]
    if n_proc > 1:
        logging.info("process %d of %d ingests %d of %d samples", rank, n_proc, len(mine),
                     len(rows))
    _ingest_samples(args, outputdir, mine)
    if barrier is not None:
        dist.barrier(group=barrier)  # every sample is aligned
        if rank != 0:
            dist.barrier(group=barrier)  # rank 0 has written the outputs
            return

    # concatenate per-reference alignments shared by >1 sample
    references = defaultdict(list)
    for prefix in prefixes:
        for aln in glob.glob(outputdir + prefix + "/*.fasta"):
            ref = re.search(r"posterior_counts_ref_(.+?)\.fasta", aln).group(1)
            references[ref].append(aln)

    alignments = []
    for ref in references:
        if len(references[ref]) <= 1:
            continue
        combined_aln = outputdir + "combined" + ref
        with open(combined_aln, "w") as outfile:
            for aln in references[ref]:
                with open(aln, "r") as fh:
                    outfile.write(fh.read())
        alignments.append(combined_aln)

    # distance reads the whole namespace; pipe has no streaming options
    args.output_file = outputdir + "transmission_distances.csv"
    args.msa_files = alignments
    args.msa_db = None
    args.row_block = None
    args.resume = False
    distance(args)

    args.distance_file = outputdir + "transmission_distances.csv"
    args.output_file = outputdir + "transmission_clusters.csv"
    cluster(args)
    if barrier is not None:
        dist.barrier(group=barrier)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser = pipe_parser(parser)
    args = parser.parse_args(argv)
    args.func(args)
