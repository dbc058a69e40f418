"""Empirical-Bayes Dirichlet-multinomial model in float64 torch on an
explicit device (counterpart of tracs_tpu/models/dirichlet.py).

* ``find_dirichlet_priors`` fits the K-dim Dirichlet-multinomial
  concentration vector by Minka's fixed-point iteration (FPI) or leave-one-out
  (LOO), after sorting each count row (the exchangeability trick of the
  original implementation, golden-tested against R's MGLM::MGLMfit).

* ``calculate_posteriors`` gives rank-tied posterior allele frequencies: the
  r-th *distinct* count value of a row gets the r-th largest alpha, ties share
  a rank, zero-coverage rows get alpha_max / alpha_0 everywhere, and
  posteriors at or below the threshold are zeroed, or clamped up to the
  threshold when ``keep`` and the raw count is positive.

Both take ``counts`` as a numpy array or a torch tensor; a tensor that lies
on ``device`` already is used where it is, so the align stage uploads a
genome's count matrix once for the fit and the posteriors.  Everything that
touches all R rows (the error filter, the polymorphic-row selection, the row
sort, the digamma sums, the rank computation) runs on the device; the fit
reads one convergence flag an iteration (a once-per-genome loop of a few
tens of steps over the polymorphic rows only), and the posteriors come back
in one copy.  JAX has no hand-written kernel here and neither has the port.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tracs_tpu_torch.runtime.device import resolve_device, to_host

_F64 = torch.float64

#: rows of a ``calculate_posteriors`` chunk: bounds the [rows, K, K] rank
#: comparison (16 bytes of bool a row at K = 4); rows are independent
_POSTERIOR_CHUNK_ROWS = 1 << 20


def _as_f64(x, device: torch.device) -> torch.Tensor:
    """``x`` as a float64 tensor on ``device``: no copy for one that is."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_F64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(device)


def _fit(data: torch.Tensor, alpha: torch.Tensor, tol: float, method: str, max_iter: int):
    """(alpha [K], iterations) of the fixed-point loop on row-sorted counts
    ``data`` [R, K] from the start ``alpha``."""
    psi = torch.special.digamma
    total = data.sum(dim=1)
    iterations = 0
    while iterations < max_iter:
        a0 = alpha.sum()
        if method == "FPI":
            num = (psi(data + alpha) - psi(alpha)).sum(dim=0)
            den = (psi(total + a0) - psi(a0)).sum()
        else:
            num = (data / (data - 1.0 + alpha)).sum(dim=0)
            den = (total / (total - 1.0 + a0)).sum()
        new = alpha * num / den
        iterations += 1
        diff = (new - alpha).abs()
        converged = bool((diff.sum() if method == "FPI" else diff.max()) < tol)
        # FPI's floor of 1e-16 applies only to a step that is followed by
        # another: the converged step leaves the loop before the clamp
        alpha = new if converged or method != "FPI" else new.clamp(min=1e-16)
        if converged:
            break
    return alpha, iterations


def find_dirichlet_priors(counts, max_iter=1000, tol=1e-5, method="FPI",
                          error_filt_threshold=None, *, device):
    """Fit Dirichlet-multinomial alphas to ``counts`` [R, K]; float64 numpy
    [K], sorted descending.  Keeps the original function's quirks: any
    ``method`` other than "LOO" selects FPI (its golden test passes 'FP'), and
    fewer than 6 polymorphic rows return the fixed 4-vector [0, 0, 0, 1.0]
    whatever K is.  ``error_filt_threshold`` zeroes, for the fit only, the
    alleles whose frequency in their row lies below it."""
    device = resolve_device(device)
    data = _as_f64(counts, device)
    if error_filt_threshold is not None:
        # alleles below the frequency threshold of their row are errors; a
        # zero-coverage row has no frequency and keeps its zeros
        rs = data.sum(dim=1, keepdim=True)
        covered = rs > 0
        freq = data / torch.where(covered, rs, torch.ones_like(rs))
        data = torch.where(covered & (freq < error_filt_threshold), torch.zeros_like(data), data)

    polymorphic = torch.count_nonzero(data, dim=1) > 1
    if not int(polymorphic.sum()) > 5:
        return np.array([0, 0, 0, 1.0])

    data = torch.sort(data[polymorphic], dim=1).values
    alpha0 = data.mean(dim=0) + 0.5
    alpha, iterations = _fit(data, alpha0, float(tol), "LOO" if method == "LOO" else "FPI",
                             int(max_iter))
    logging.info("Dirichlet fit: %d iterations over %d polymorphic rows", iterations,
                 data.shape[0])
    return np.sort(to_host(alpha))[::-1].copy()


def _posteriors_chunk(counts, alphas, a0, keep: bool, expected: torch.Tensor):
    """Posteriors of a chunk of rows: counts [r, K], alphas [K] descending,
    ``expected`` a float64 scalar tensor."""
    denom = counts.sum(dim=1, keepdim=True)
    # distinct rank: for element j, the number of distinct values of its row
    # strictly greater than counts[j], which is where a walk over a stable
    # descending argsort that advances at value boundaries would stand
    s = torch.sort(counts, dim=1, descending=True).values
    is_new = torch.zeros_like(s, dtype=torch.bool)
    is_new[:, 1:] = s[:, 1:] < s[:, :-1]
    gt = s[:, :, None] > counts[:, None, :]  # [r, K (sorted m), K (element j)]
    # is_new[0] is False: the largest value's slot is counted by the any()
    # term (s[0] > v iff any value > v, s being sorted descending)
    rank = (gt & is_new[:, :, None]).sum(dim=1) + gt.any(dim=1).long()

    post = (counts + alphas[rank]) / (denom + a0)
    post = torch.where(denom <= 0, alphas[0] / a0, post)
    below = post <= expected
    low = torch.zeros((), dtype=_F64, device=counts.device)
    if keep:
        low = torch.where(counts > 0, expected, low)
    return torch.where(below, low, post)


def posteriors_on_device(counts, alphas, keep, expected, *, device) -> torch.Tensor:
    """``calculate_posteriors`` as a float64 tensor [R, K] left on ``device``,
    for a caller that goes on working there (the align stage finds the
    distinct values before anything comes back).  Rows are independent and go
    through the device in chunks of ``_POSTERIOR_CHUNK_ROWS``."""
    device = resolve_device(device)
    counts = _as_f64(counts, device)
    alphas = torch.from_numpy(np.sort(np.asarray(alphas, dtype=np.float64))[::-1].copy()).to(device)
    a0 = alphas.sum()
    keep = bool(keep)
    expected = torch.tensor(float(expected), dtype=_F64, device=device)
    out = torch.empty_like(counts)
    for r0 in range(0, counts.shape[0], _POSTERIOR_CHUNK_ROWS):
        r1 = r0 + _POSTERIOR_CHUNK_ROWS
        out[r0:r1] = _posteriors_chunk(counts[r0:r1], alphas, a0, keep, expected)
    return out


def calculate_posteriors(counts, alphas, keep, expected, *, device):
    """Posterior allele frequencies, float64 numpy [R, K] (writable: callers
    overwrite rows), of counts [R, K] under alphas of length K (sorted
    descending here); the result comes back in one copy."""
    return to_host(posteriors_on_device(counts, alphas, keep, expected, device=device))
