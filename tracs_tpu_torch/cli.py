"""CLI dispatcher: ``tracs-tpu-torch <subcommand>`` with the nine subcommands
of ``tracs-tpu``: ``align``, ``combine``, ``distance``, ``threshold``,
``cluster``, ``build-db``, ``pipe``, ``plot`` and ``doctor``.  Importing it
imports no plotting package: ``plot`` imports matplotlib when it draws."""

from __future__ import annotations

import argparse

from tracs_tpu_torch import __version__
from tracs_tpu_torch.runtime.device import DeviceUnavailableError
from tracs_tpu_torch.stages.align import align_parser
from tracs_tpu_torch.stages.build_db import build_db_parser
from tracs_tpu_torch.stages.cluster import cluster_parser
from tracs_tpu_torch.stages.combine import combine_parser
from tracs_tpu_torch.stages.distance import distance_parser
from tracs_tpu_torch.stages.doctor import doctor_parser
from tracs_tpu_torch.stages.pipe import pipe_parser
from tracs_tpu_torch.stages.plots import plots_parser
from tracs_tpu_torch.stages.threshold import threshold_parser

SUBCOMMANDS = {"align": align_parser, "combine": combine_parser, "distance": distance_parser,
               "threshold": threshold_parser, "cluster": cluster_parser,
               "build-db": build_db_parser, "pipe": pipe_parser, "plot": plots_parser,
               "doctor": doctor_parser}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tracs-tpu-torch")
    subparsers = parser.add_subparsers(help="select a subcommand", dest="command")
    parser.add_argument(
        "--version", action="version", version="%(prog)s " + __version__
    )
    for name, add_arguments in SUBCOMMANDS.items():
        add_arguments(subparsers.add_parser(name))

    args = parser.parse_args(argv)
    func = getattr(args, "func", None)
    if func is None:
        parser.error("Too few inputs. For help, run tracs-tpu-torch --help")
    try:
        rc = func(args)
    except DeviceUnavailableError as e:
        raise SystemExit(f"tracs-tpu-torch: {e}") from e
    if isinstance(rc, int) and rc:
        raise SystemExit(rc)


if __name__ == "__main__":
    main()
