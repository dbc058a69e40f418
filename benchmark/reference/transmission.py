"""The TransCluster transmission model in NumPy (Stimson et al. 2019, the
second variant of tracs' src/transcluster.hpp): for a pair N SNPs and delta
years apart, log P(k intermediate hosts | N, delta) with clock rate lambda
and transmission rate beta, p0 = P(k = 0) and E(K) = sum_k k P(k), summed
until the analytic upper bound of E(K) minus the partial sum of its terms is
at most the threshold (tracs' ``--precision``) or k reaches 10,000.

Two rules follow the program's documented semantics: with delta = 0 the
bound is NaN (0 * log 0) and the sum stops after k = 1; where bound * 1e-12
reaches the threshold the bound test cannot be resolved in float64 and the
sum runs to the k cap.  ``dtype=np.float32`` computes the same in single
precision (the control).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

SECONDS_IN_YEAR = 31556952.0
K_CAP = 10000


def years_apart(day_i: np.ndarray, day_j: np.ndarray, dtype=np.float64) -> np.ndarray:
    """|day_i - day_j| in years of 31,556,952 s."""
    secs = np.abs(day_i - day_j).astype(dtype) * dtype(86400.0)
    return secs / dtype(SECONDS_IN_YEAR)


def _logsumexp(terms: np.ndarray) -> np.ndarray:
    """log sum exp over the last axis; a NaN term gives NaN."""
    m = terms.max(axis=-1)
    safe = np.where(np.isfinite(m), m, 0.0).astype(terms.dtype)
    return np.where(np.isfinite(m), safe + np.log(np.exp(terms - safe[:, None]).sum(axis=-1)), m)


def _lanes(N, delta, lamb, beta, threshold, dt):
    """(log p0, E(K)) of distinct lanes."""
    one = dt(1.0)
    lamb, beta, threshold = dt(lamb), dt(beta), dt(threshold)
    log_lamb, log_beta, log_lb = np.log(lamb), np.log(beta), np.log(lamb + beta)
    pos = delta > 0
    n_max = int(N.max())
    i = np.arange(n_max + 1, dtype=dt)[None, :]
    upto_n = i <= N[:, None]
    # log sum_{i<=N} (lamb delta)^i / i!  (NaN where delta = 0: 0 * log 0)
    log_pois = _logsumexp(np.where(upto_n, i * np.log(lamb * delta)[:, None] - gammaln(i + one),
                                   -np.inf).astype(dt))
    # log I(M) = log sum_{j<=M} delta^j / j! / (lamb + beta)^(M - j + 1), at M = N
    log_i = _logsumexp(np.where(upto_n & pos[:, None],
                                i * np.log(delta)[:, None] - gammaln(i + one)
                                - (N[:, None] - i + one) * log_lb, -np.inf).astype(dt))
    lg_n1 = gammaln(N + one)

    def lprob(a, k, log_i_m):
        """(log P(k | N, delta), the same without the integral) of lanes a."""
        n_a = N[a]
        base = (n_a + one) * log_lamb + k * log_beta + gammaln(n_a + k + one) - lg_n1[a] \
            - gammaln(k + one)
        base_pos = base - delta[a] * beta - log_pois[a]
        zero = base - (n_a + k + one) * log_lb
        return np.where(pos[a], base_pos + log_i_m, zero), np.where(pos[a], base_pos, zero)

    log_p0 = lprob(slice(None), dt(0.0), log_i)[0]
    upper = np.exp(log_beta + delta * lamb + np.log(N + one) - (log_lamb + log_pois))
    usable = ~(upper * dt(1e-12) >= threshold)

    m = len(N)
    e_sum = np.zeros(m, dtype=dt)
    b_sum = np.zeros(m, dtype=dt)
    active = np.arange(m)
    k = 1
    while active.size:
        a = active
        n_a, d_a = N[a], delta[a]
        mm = n_a + dt(k)
        log_i[a] = np.logaddexp(mm * np.log(d_a) - gammaln(mm + one) - log_lb, log_i[a] - log_lb)
        lp, lhs = lprob(a, dt(k), log_i[a])
        log_k = np.log(dt(k))
        e_sum[a] += np.exp(lp + log_k)
        b_sum[a] += np.exp(lhs + log_k + d_a * (lamb + beta) - (n_a + dt(k) + one) * log_lb)
        done = (usable[a] & ~(upper[a] - b_sum[a] > threshold)) | (k + 1 >= K_CAP)
        active = a[~done]
        k += 1
    return log_p0, e_sum


def trans_dist(snps: np.ndarray, years: np.ndarray, lamb: float, beta: float,
               threshold: float, dtype=np.float64):
    """(log p0, E(K)) of each pair, evaluated once per distinct (N, delta)."""
    keys = np.stack([np.asarray(snps, dtype=np.float64), np.asarray(years, dtype=np.float64)], 1)
    if len(keys) == 0:
        return np.zeros(0, dtype=dtype), np.zeros(0, dtype=dtype)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    with np.errstate(all="ignore"):
        log_p0, e_k = _lanes(uniq[:, 0].astype(dtype), uniq[:, 1].astype(dtype),
                             lamb, beta, threshold, dtype)
    inverse = inverse.reshape(-1)
    return log_p0[inverse], e_k[inverse]
