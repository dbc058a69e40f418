"""``threshold`` stage: estimate a SNP cutoff separating recent
transmission from background diversity (counterpart of
tracs_tpu/stages/threshold.py; host-only scipy, no ``--device``).

Statistical contract (reference tracs/threshold.py:56-107): the "distant"
pair distances are modelled as NegativeBinomial(r, p) fitted by
Nelder-Mead MLE; the "close" pairs as a two-component mixture
q * Poisson(lambda) + (1-q) * NB(r, p) with (r, p) frozen from the distant
fit; the reported cutoff is ``3 * Poisson_ppf(0.95; lambda)``.

Deviations (deliberate, documented):
* the reference accepts ``-o`` but never writes the file
  (threshold.py:100-107); here the fitted parameters and the cutoff land
  in a ``parameter,value`` CSV.
* the reference hands the *positive* mixture log-likelihood to a
  minimiser (threshold.py:67,98), converging on the worst-fitting
  parameters; here the negative log-likelihood is minimised so the
  mixture fit is an actual MLE, with out-of-domain parameters rejected
  as +inf instead of silently producing NaN likelihoods.
"""

from __future__ import annotations

import argparse
import csv
import logging
import math
import os
from dataclasses import dataclass, fields

import numpy as np
from scipy import optimize, stats

from tracs_tpu_torch.utils import setup_logging


@dataclass
class ThresholdFit:
    """Fitted generative model of close/distant pair SNP distances."""

    r: float  # NB shape, background (distant) pairs
    p: float  # NB success prob, background pairs
    q: float  # mixture weight of the Poisson (transmission) component
    lambd: float  # Poisson mean of the transmission component

    @property
    def snp_threshold(self) -> float:
        # 95th percentile of the transmission component, tripled for slack
        # (reference threshold.py:103)
        return float(stats.poisson.ppf(0.95, mu=self.lambd) * 3)

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("parameter,value\n")
            for f in fields(self):
                fh.write(f"{f.name.replace('lambd', 'lambda')},{getattr(self, f.name)}\n")
            fh.write(f"snp_threshold,{self.snp_threshold}\n")


def _read_snp_column(path: str, column: int) -> np.ndarray:
    """One numeric column of a headered CSV (header row skipped)."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        next(reader, None)
        vals = [float(row[column]) for row in reader if row]
    return np.asarray(vals)


def _nelder_mead_mle(neg_ll, x0) -> np.ndarray:
    return optimize.minimize(neg_ll, np.asarray(x0, dtype=float), method="nelder-mead").x


def fit_background(distances: np.ndarray) -> tuple[float, float]:
    """MLE NegativeBinomial(r, p) for the distant (background) pairs."""

    def neg_ll(params):
        r, p = params
        if not (r > 0 and 0 < p < 1):
            return math.inf
        return -stats.nbinom.logpmf(distances, r, p).sum()

    r, p = _nelder_mead_mle(neg_ll, [100.0, 0.5])
    return float(r), float(p)


def fit_mixture(distances: np.ndarray, r: float, p: float) -> tuple[float, float]:
    """MLE of q * Poisson(lambda) + (1-q) * NB(r, p) over the close pairs,
    with the background component frozen."""
    bg_logpmf = stats.nbinom.logpmf(distances, r, p)  # data-constant per fit

    def neg_ll(params):
        q, lambd = params
        if not (0 < q < 1 and lambd > 0):
            return math.inf
        per_pair = np.logaddexp(
            math.log(q) + stats.poisson.logpmf(distances, mu=lambd),
            math.log1p(-q) + bg_logpmf,
        )
        return -per_pair.sum()

    q, lambd = _nelder_mead_mle(neg_ll, [0.5, 1.0])
    return float(q), float(lambd)


def estimate_thresholds(close_file, distant_file, outfile, column) -> float:
    logging.info("Loading distances...")
    close = _read_snp_column(close_file, column)
    distant = _read_snp_column(distant_file, column)

    logging.info("Fitting distribution...")
    fit = ThresholdFit(*fit_background(distant), *(np.nan, np.nan))
    fit.q, fit.lambd = fit_mixture(close, fit.r, fit.p)

    logging.info(
        "Fitted parameters - r:%s, p:%s, q:%s, lambda:%s",
        fit.r, fit.p, fit.q, fit.lambd,
    )
    logging.info("SNP threshold: %s", fit.snp_threshold)

    if outfile:
        fit.write(outfile)
    return fit.snp_threshold


def threshold_parser(parser):
    parser.description = "Estimates transmission thresholds."

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "--close", dest="close_file", required=True, type=os.path.abspath,
        help="path to csv file with distances between isolates mostly linked "
             "by recent transmission",
    )
    io_opts.add_argument(
        "--distant", dest="distant_file", required=True, type=os.path.abspath,
        help="path to csv file with distances between isolates not related "
             "by recent transmission",
    )
    io_opts.add_argument(
        "-o", "--output", dest="output_file", required=True,
        type=os.path.abspath, help="location of an output file",
    )
    io_opts.add_argument(
        "--column", dest="column", default=1, type=int,
        help="index of column containing SNP distances (default=1)",
    )

    parser.set_defaults(func=threshold)
    return parser


def threshold(args):
    setup_logging(getattr(args, "loglevel", "INFO"))
    estimate_thresholds(
        args.close_file, args.distant_file, args.output_file, args.column
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    threshold_parser(parser)
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
