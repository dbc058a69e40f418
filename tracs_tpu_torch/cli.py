"""CLI dispatcher: ``tracs-tpu-torch <subcommand>`` with the subcommands of
``tracs-tpu``.  ``align``, ``combine``, ``distance``, ``cluster`` and
``pipe`` are ported; the others print that they are not yet ported and exit
non-zero."""

from __future__ import annotations

import argparse
import sys

from tracs_tpu_torch import __version__
from tracs_tpu_torch.runtime.device import DeviceUnavailableError
from tracs_tpu_torch.stages.align import align_parser
from tracs_tpu_torch.stages.cluster import cluster_parser
from tracs_tpu_torch.stages.combine import combine_parser
from tracs_tpu_torch.stages.distance import distance_parser
from tracs_tpu_torch.stages.pipe import pipe_parser

_PORTED = {"align": align_parser, "combine": combine_parser, "distance": distance_parser,
           "cluster": cluster_parser, "pipe": pipe_parser}
_NOT_YET_PORTED = ["threshold", "build-db", "plot", "doctor"]


def _not_ported(name):
    def run(args):
        print(f"tracs-tpu-torch: '{name}' is not yet ported (see ROADMAP.md); "
              f"use tracs-tpu {name}", file=sys.stderr)
        return 2
    return run


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tracs-tpu-torch")
    subparsers = parser.add_subparsers(help="select a subcommand", dest="command")
    parser.add_argument(
        "--version", action="version", version="%(prog)s " + __version__
    )
    for name, add_arguments in _PORTED.items():
        add_arguments(subparsers.add_parser(name))
    for name in _NOT_YET_PORTED:
        subparsers.add_parser(name, help="not yet ported").set_defaults(
            func=_not_ported(name)
        )

    # a not-yet-ported subcommand takes whatever arguments tracs-tpu's does
    args, extra = parser.parse_known_args(argv)
    if extra and args.command not in _NOT_YET_PORTED:
        parser.error("unrecognized arguments: " + " ".join(extra))
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
