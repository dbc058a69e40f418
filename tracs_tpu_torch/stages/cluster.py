"""``cluster`` stage: single-linkage transmission clusters (counterpart of
tracs_tpu/stages/cluster.py; host only, no device code).

The metric picks a column of the distance CSV (snp 3, filter 6, direct 4,
expectedK 5), edges are the pairs whose value is <= the threshold, clusters
are the connected components, and samples are numbered in order of first
appearance in the distance file, so a sample appears only if some row names
it.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from tracs_tpu_torch.runtime.native import native_read_dist_csv
from tracs_tpu_torch.utils import add_loglevel_arg, setup_logging

_METRIC_COLUMNS = {"snp": 3, "filter": 6, "direct": 4, "expectedK": 5}


def cluster_parser(parser):
    parser.description = (
        "Groups samples into putative transmission clusters using single "
        "linkage clustering"
    )

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "-d", "--distances", dest="distance_file", required=True,
        help="Pairwise distance estimates obtained from running the "
             "'distance' function",
        type=os.path.abspath,
    )
    io_opts.add_argument(
        "-o", "--output", dest="output_file", required=True,
        help="name of the output file to store the resulting cluster assignments",
        type=str,
    )

    cluster_opts = parser.add_argument_group("Cluster options")
    cluster_opts.add_argument(
        "-c", "--threshold", dest="threshold",
        help="Distance threshold. Samples will be grouped together if the "
             "distance between them is below this threshold.",
        type=float, required=True,
    )
    cluster_opts.add_argument(
        "-D", "--distance", dest="distance",
        help="The type of transmission distance to use. Can be one of "
             "'snp', 'filter', 'direct', 'expectedK'",
        choices=["snp", "filter", "direct", "expectedK"],
        type=str, required=True,
    )

    add_loglevel_arg(parser)
    parser.set_defaults(func=cluster)
    return parser


def read_dist_csv(path, col_index: int, threshold: float):
    """(I, J, names, n_rows) of a distance CSV with the ``csv`` module, what
    ``native_read_dist_csv`` returns: the header is skipped blindly, samples
    are numbered at their first appearance scanning (sampleA, sampleB) row by
    row, and the metric column goes through ``float()``, so a literal ``NA``
    raises ValueError."""
    ids: dict[str, int] = {}
    I, J = [], []
    n_rows = 0
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        next(reader, None)
        for row in reader:
            if len(row) < 2 or col_index >= len(row):
                raise ValueError("malformed distance CSV row (too few columns)")
            a = ids.setdefault(row[0].strip(), len(ids))
            b = ids.setdefault(row[1].strip(), len(ids))
            try:
                value = float(row[col_index])
            except ValueError:
                raise ValueError(
                    f"could not convert distance column {col_index} to float") from None
            if value <= threshold:
                I.append(a)
                J.append(b)
            n_rows += 1
    return np.asarray(I, dtype=np.int64), np.asarray(J, dtype=np.int64), list(ids), n_rows


def cluster(args):
    setup_logging(args.loglevel)
    col_index = _METRIC_COLUMNS[args.distance]

    # the native reader (a 10k-sample all-pairs run emits ~50M rows), the csv
    # module when the library could not be built
    parsed = native_read_dist_csv(args.distance_file, col_index, args.threshold)
    if parsed is None:
        parsed = read_dist_csv(args.distance_file, col_index, args.threshold)
    I, J, names, n_rows = parsed
    if n_rows <= 0:
        logging.warning("No distances available! Abandoning clustering.")
        return

    logging.info("Clustering %s samples...", len(names))
    graph = csr_matrix((np.ones(len(I), dtype=np.int64), (I, J)),
                       shape=(len(names), len(names)))
    n_components, labels = connected_components(csgraph=graph, directed=False,
                                                return_labels=True)
    logging.info("%s putative transmission clusters found!", n_components)

    with open(args.output_file, "w") as outfile:
        outfile.write("sample,cluster\n")
        for name, label in zip(names, labels):
            outfile.write(name + "," + str(label) + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser = cluster_parser(parser)
    args = parser.parse_args(argv)
    args.func(args)
