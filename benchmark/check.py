"""What decides ``correct``: the program's outputs of the window, against the
plain references (reference/), number by number, each beside its limit.

A sweep's outputs are its survivors (row, col, D, NN) in row-major order; a
job's are its CSV file.  The reference recomputes every pair's D and NN from
the generated planes on the card, the filtered distance from every mismatch
position, and the date difference, p0 and E(K) from the generated dates.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import recomb, transmission
from benchmark.reference.distances import Distances

HEADER = ("sampleA,sampleB,date difference,SNP distance,transmission distance,"
          "expected K,filtered SNP distance,sites considered,MSA file")


def _exact_gap(x, ref) -> int:
    """Largest absolute difference of two integer arrays of one length."""
    return int(np.abs(np.asarray(x, dtype=np.int64) - ref).max()) if len(ref) else 0


def _rel_gap(x, ref) -> float:
    """Largest |x - ref| / |ref| (0 where both are 0; NaN on one side only
    counts as infinite)."""
    x, ref = np.asarray(x, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if not len(ref):
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(x - ref) / np.abs(ref)
    gap = np.where(x == ref, 0.0, gap)
    gap = np.where(np.isnan(x) & np.isnan(ref), 0.0, np.where(np.isnan(gap), np.inf, gap))
    return float(gap.max())


def _rows_differ(rows, cols, ref_rows, ref_cols) -> int:
    """Positions whose (row, col) differ, plus the difference in length."""
    m = min(len(rows), len(ref_rows))
    differ = (rows[:m] != ref_rows[:m]) | (cols[:m] != ref_cols[:m])
    return int(differ.sum()) + abs(len(rows) - len(ref_rows))


class Expected:
    """The reference's answer for one configuration and seed."""

    def __init__(self, cfg: dict, planes: np.ndarray, days: np.ndarray | None, device, *,
                 filtered: bool = False, partial_correction: bool = True,
                 dtype=np.float64):
        ref = Distances(planes, cfg["sites"], device, partial_correction=partial_correction)
        self.rows, self.cols, self.d, self.nn = ref.survivors(cfg["snp_threshold"])
        self.filt = None
        if filtered:
            pair, site = ref.mismatch_positions(self.rows, self.cols)
            self.filt = recomb.filtered_distances(pair, site, len(self.rows), cfg["sites"])
        del ref
        self.years = self.p0 = self.ek = None
        if days is not None:
            self.years = transmission.years_apart(days[self.rows], days[self.cols], dtype)
            n = self.filt if filtered else self.d
            log_p0, self.ek = transmission.trans_dist(
                n, self.years, cfg["clock_rate"], cfg["trans_rate"], cfg["precision"], dtype)
            self.p0 = np.exp(log_p0)


def sweep_checks(outputs: list, exp: Expected) -> dict:
    """Numbers compared for sampled sweeps: each (rows, cols, d, nn)."""
    rows_differ = d_gap = nn_gap = 0
    for rows, cols, d, nn in outputs:
        rows_differ = max(rows_differ, _rows_differ(rows, cols, exp.rows, exp.cols))
        m = min(len(rows), len(exp.rows))
        d_gap = max(d_gap, _exact_gap(d[:m], exp.d[:m]))
        nn_gap = max(nn_gap, _exact_gap(nn[:m], exp.nn[:m]))
    return {"rows_differ": rows_differ, "d_gap": d_gap, "nn_gap": nn_gap}


def read_job_csv(path: str) -> dict:
    """The columns of a ``distance`` CSV as text lists, and its header."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    fields = [line.split(",") for line in lines[1:]]
    cols = list(zip(*fields)) if fields else [()] * 9
    if any(len(f) != 9 for f in fields):
        raise ValueError(f"{path}: a row without 9 fields")
    return {"header": lines[0] if lines else "", "cols": cols}


def job_columns(exp: Expected, ref_name: str, meta: bool, filtered: bool, dtype=np.float64):
    """The reference's answer as the job's columns would hold it (the control
    path: the reference put in the program's place)."""
    fmt = lambda xs: [repr(float(x)) for x in xs]
    na = ["NA"] * len(exp.rows)
    return {"header": HEADER, "cols": [
        [str(i) for i in exp.rows], [str(j) for j in exp.cols],
        fmt(exp.years) if meta else na, [str(int(x)) for x in exp.d],
        fmt(exp.p0) if meta else na, fmt(exp.ek) if meta else na,
        [str(int(x)) for x in exp.filt] if filtered else (na if meta else ["0"] * len(exp.rows)),
        [str(int(x)) for x in exp.nn], [ref_name] * len(exp.rows)]}


def job_checks(jobs: list, exp: Expected, ref_name: str, meta: bool, filtered: bool) -> dict:
    """Numbers compared for sampled jobs: each ``read_job_csv`` dict."""
    out = {"rows_differ": 0, "d_gap": 0, "nn_gap": 0, "text_differ": 0}
    if filtered:
        out["filt_gap"] = 0
    if meta:
        out.update(years_gap=0.0, p0_gap=0.0, ek_gap=0.0)
    for job in jobs:
        c = job["cols"]
        rows, cols = np.array(c[0], dtype=np.int64), np.array(c[1], dtype=np.int64)
        m = min(len(rows), len(exp.rows))
        gaps = {"rows_differ": _rows_differ(rows, cols, exp.rows, exp.cols),
                "d_gap": _exact_gap(np.array(c[3][:m], dtype=np.int64), exp.d[:m]),
                "nn_gap": _exact_gap(np.array(c[7][:m], dtype=np.int64), exp.nn[:m])}
        # the header, the MSA name, and NA (or 0) where a column is not filled
        text = int(job["header"] != HEADER) + sum(x != ref_name for x in c[8])
        unfilled = ([2, 4, 5] if not meta else []) + ([6] if not filtered else [])
        for k in unfilled:
            text += sum(x != ("NA" if meta or k != 6 else "0") for x in c[k])
        gaps["text_differ"] = text
        if filtered:
            gaps["filt_gap"] = _exact_gap(np.array(c[6][:m], dtype=np.int64), exp.filt[:m])
        if meta:
            for key, k, ref in (("years_gap", 2, exp.years), ("p0_gap", 4, exp.p0),
                                ("ek_gap", 5, exp.ek)):
                gaps[key] = _rel_gap(np.array(c[k][:m], dtype=np.float64), ref[:m])
        out = {k: max(v, gaps[k]) for k, v in out.items()}
    return out
