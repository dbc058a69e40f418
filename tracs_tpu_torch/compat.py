"""Drop-in layer for the four functions of the original ``TRACS`` binding
(counterpart of tracs_tpu/compat.py):

    from TRACS import pairsnp, lprob_k_given_N, trans_dist, calculate_posteriors

Code written against that interface runs against this module:

    import tracs_tpu_torch.compat as TRACS

Signatures, argument names and return structures match.  The binding has no
device argument, so each function here takes ``device`` as a keyword that
defaults to the card, as every entry point of the port does.
"""

from __future__ import annotations

import numpy as np

from tracs_tpu_torch.models.dirichlet import calculate_posteriors as _calculate_posteriors
from tracs_tpu_torch.models.transcluster import lprob_k_given_N as _lprob_k_given_N
from tracs_tpu_torch.models.transcluster import trans_dist as _trans_dist
from tracs_tpu_torch.ops.pairsnp import pairsnp as _pairsnp


def pairsnp(fasta, n_threads=1, dist=2**31 - 1, filter=False, *, device="cuda"):
    """(rows, cols, distances, seq_names, filt_distances, n_compared_sites)
    as Python lists, the binding's return convention."""
    return _pairsnp(fasta, n_threads=n_threads, dist=dist, filter=filter, device=device)


def lprob_k_given_N(N, k, delta, lamb, beta, lgamma):
    """(lprob, lhs) tuple; scalar host arithmetic."""
    return _lprob_k_given_N(N, k, delta, lamb, beta, lgamma)


def trans_dist(snpdiff, datediff, lamb, beta, threshold_Ek=1e-6, *, device="cuda"):
    """(p0, eK) as lists; p0 is in log space."""
    p0, eK = _trans_dist(snpdiff, datediff, lamb, beta, threshold_Ek, device=device)
    return list(p0), list(eK)


def calculate_posteriors(counts, alphas, keep, expected, *, device="cuda"):
    """float64 [R, K] posterior matrix."""
    return _calculate_posteriors(np.asarray(counts), alphas, keep, expected, device=device)
