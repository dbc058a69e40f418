"""TransCluster model in torch float64: P(k intermediate hosts | N SNPs, time
gap delta) and E(K) per sample pair (counterpart of
tracs_tpu/models/transcluster.py, which follows the Stimson et al. 2019 model
of the reference C++ kernel, src/transcluster.hpp).

* ``lprob_k_given_N``, ``upper_bound_E`` — the reference's scalar first
  variant and its E(K) bound, in plain Python as in ``tracs_tpu``.
* ``trans_dist`` — (log p0, E(K)) per pair: the unique (N, delta) lanes are
  seeded in chunks with adaptive series caps (float64 elementwise tensor
  work), then ``trans_k_loop`` runs each lane's k loop to its own exit: on
  a card one launch of the kernel ``csrc/trans_k_loop.cu``, a thread a
  lane; on the CPU its plain version, geometrically growing blocks of steps
  with active-lane compaction between blocks.  Everything runs on the
  ``device`` it is given, in float64; the H100 has native float64, so
  unlike the JAX package (whose TPU has none) the model runs on the card.
* ``TransClusterCache`` — the (N, delta) memo across streamed row blocks.
* ``calculate_trans_prob`` — the date glue of the distance stage.

delta == 0 quirk: the reference computes ``upper_bound_E`` with
``log(lamb*delta) = -inf`` and ``0 * -inf = NaN``, so the bound is NaN and
the k-loop exits after k=1, giving E(K) = P(k=1|N).  The NaN arises here
through the identical expression, and ``_masked_logsumexp`` propagates it.
"""

from __future__ import annotations

import math
from datetime import date

import numpy as np
import torch

from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.runtime.device import resolve_device, to_host
from tracs_tpu_torch.runtime.profiling import count, span

SECONDS_IN_YEAR = 31556952.0  # reference tracs/transcluster.py:5

_K_CAP = 10000  # reference transcluster.hpp:207: while (... && k<10000)
_SEED_CHUNK = 8192  # lanes per seed-series evaluation (bounds the [B, cap] temp)
_EPOCH = date(1970, 1, 1)
_F64 = torch.float64


# ---------------------------------------------------------------------------
# scalar public API (plain Python, as in tracs_tpu)
# ---------------------------------------------------------------------------

def lprob_k_given_N(N, k, delta, lamb, beta, lgamma):
    """Log-probability of k intermediate hosts given N SNPs and time gap
    delta, with the passed-in lgamma table and the reference's i-ascending
    logaddexp order (src/transcluster.hpp:90-129).  Returns (lprob, lhs)."""
    lgamma = np.asarray(lgamma, dtype=np.float64)
    N, k = int(N), int(k)
    delta, lamb, beta = float(delta), float(lamb), float(beta)

    if delta > 0:
        lprob = (N + 1) * math.log(lamb) - delta * (lamb + beta) + k * math.log(beta) - lgamma[k + 1]
        pois_cdf = -math.inf
        for i in range(N + 1):
            pois_cdf = np.logaddexp(i * math.log(lamb * delta) - lgamma[i + 1], pois_cdf)
        lprob -= pois_cdf - lamb * delta
        integral = -math.inf
        for i in range(N + k + 1):
            integral = np.logaddexp(
                lgamma[N + k + 1] - lgamma[i + 1] - lgamma[N + k - i + 1]
                + (N + k - i) * math.log(delta) + lgamma[i + 1]
                - (i + 1) * math.log(lamb + beta),
                integral,
            )
        lhs = lprob
        lprob += integral - lgamma[N + 1]
    else:
        lprob = (
            (N + 1) * math.log(lamb) + k * math.log(beta) + lgamma[N + k + 1]
            - lgamma[N + 1] - lgamma[k + 1] - (N + k + 1) * math.log(lamb + beta)
        )
        lhs = lprob
    return float(lprob), float(lhs)


def upper_bound_E(delta, lamb, beta, N, lgamma=None):
    """Analytic upper bound on E(K) (reference transcluster.hpp:173-188).
    ``lgamma`` is accepted for signature parity; lgamma is evaluated
    directly."""
    pois = -math.inf
    for i in range(int(N) + 1):
        pois = np.logaddexp(i * math.log(lamb * delta) - math.lgamma(i + 1), pois)
    return math.exp(math.log(beta) + delta * lamb + math.log(N + 1) - (math.log(lamb) + pois))


def expected_k(N, delta, lamb, beta, threshold_Ek=1e-6, *, device):
    """E(K): expected intermediate hosts for one (N SNPs, delta years) pair."""
    _, eK = trans_dist([int(N)], [float(delta)], lamb, beta, threshold_Ek, device=device)
    return float(eK[0])


# ---------------------------------------------------------------------------
# the vectorised engine (the reference's second variant)
# ---------------------------------------------------------------------------

def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b) by jnp.logaddexp's formula on every device:
    (-inf, -inf) gives -inf and a NaN operand gives NaN."""
    d = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-d.abs()))
    return torch.where(torch.isnan(d), a + b, out)


def _masked_logsumexp(terms: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis of the ``mask``ed terms.  NaN in an
    unmasked term propagates (deliberate: the delta == 0 quirk), which
    ``torch.logsumexp`` does not promise."""
    t = torch.where(mask, terms, -math.inf)
    m = t.amax(dim=-1)
    finite = torch.isfinite(m)
    safe_m = torch.where(finite, m, 0.0)
    s = torch.where(mask, torch.exp(t - safe_m[..., None]), 0.0).sum(dim=-1)
    return torch.where(finite, safe_m + torch.log(s), m)


def _log_pois_cdf_sum(N, delta, lamb: float, cap: int):
    """log sum_{i=0..N} (lamb*delta)^i / i!, with no exp(-lamb*delta) factor
    (both call sites handle it themselves, transcluster.hpp:144-149,
    178-185), truncated at ``cap`` terms: the caller picks cap so the tail
    is below e^-200 of the sum.  The i=0 term is 0 * log(0) = NaN when
    delta == 0, as in the reference."""
    i = torch.arange(cap + 1, dtype=_F64, device=N.device)
    terms = i[None, :] * torch.log(lamb * delta)[:, None] - torch.lgamma(i + 1.0)[None, :]
    return _masked_logsumexp(terms, i[None, :] <= N[:, None])


def _log_integral_direct(M, delta, log_lb: float, cap: int):
    """log I(M) = log sum_{i=0..M} delta^(M-i) / ((M-i)! (lamb+beta)^(i+1)),
    summed over j = M-i (the terms decay past j ~ delta*(lamb+beta)) and
    truncated at ``cap`` terms.  Valid for delta > 0 lanes only."""
    j = torch.arange(cap + 1, dtype=_F64, device=M.device)
    terms = (
        j[None, :] * torch.log(delta)[:, None]
        - torch.lgamma(j + 1.0)[None, :]
        - (M[:, None] - j[None, :] + 1.0) * log_lb
    )
    return _masked_logsumexp(terms, j[None, :] <= M[:, None])


def _lprob2_given_logI(N, k, delta, lamb, beta, log_pois, log_I):
    """Variant-2 log-prob (reference transcluster.hpp:131-170) from the
    Poisson log-sum and the log-integral.  Returns (lprob, lhs)."""
    lg = torch.lgamma
    base = (
        (N + 1.0) * math.log(lamb) + k * math.log(beta)
        + lg(N + k + 1.0) - lg(N + 1.0) - lg(k + 1.0)
    )
    # the variant-2 Poisson sum has no -lamb*delta (transcluster.hpp:144-149)
    base_pos = base - delta * beta - log_pois
    lprob_zero = base - (N + k + 1.0) * math.log(lamb + beta)
    pos = delta > 0
    return (torch.where(pos, base_pos + log_I, lprob_zero),
            torch.where(pos, base_pos, lprob_zero))


def _exit_rule(done, k, diff_bound, upper_bound, threshold_Ek, extra=None):
    """The k-loop's exit: the reference's ``diff_bound > threshold_Ek`` test,
    or the k cap.  Guard: where upper_bound * 1e-12 >= threshold_Ek the
    tail can never be resolved below the threshold in f64, the subtraction
    is cancellation noise and exact math runs to the k cap, so the bound
    test is skipped there (PARITY.md deviation 2).  A NaN bound (delta == 0)
    keeps its immediate exit.  ``extra`` is a further exit condition for
    the lanes whose bound is unusable."""
    usable = ~(upper_bound * 1e-12 >= threshold_Ek)
    out = done | (usable & ~(diff_bound > threshold_Ek)) | (k + 1.0 >= _K_CAP)
    if extra is not None:
        out = out | (~usable & extra)
    return out


def _k_step(N, delta, log_pois, upper_bound, lamb, beta, log_lb, threshold_Ek, state):
    """One k iteration in log space (reference k-loop body,
    transcluster.hpp:207-235): the monolithic oracle's step."""
    k, lprob, elprob, log_I, done = state
    M = N + k
    log_I_next = _logaddexp(M * torch.log(delta) - torch.lgamma(M + 1.0) - log_lb,
                            log_I - log_lb)
    lp_k, lhs_k = _lprob2_given_logI(N, k, delta, lamb, beta, log_pois, log_I_next)
    log_k = torch.log(k)
    lprob_new = _logaddexp(lprob, lp_k + log_k)
    elprob_new = _logaddexp(
        elprob, lhs_k + log_k + delta * (lamb + beta) - (N + k + 1.0) * log_lb)
    done_new = _exit_rule(done, k, upper_bound - torch.exp(elprob_new), upper_bound,
                          threshold_Ek)
    return (
        torch.where(done, k, k + 1.0),
        torch.where(done, lprob, lprob_new),
        torch.where(done, elprob, elprob_new),
        torch.where(done, log_I, log_I_next),
        done_new,
    )


def _seed_batch(N, delta, *, lamb, beta, cap_pois, cap_int):
    """Per-lane loop invariants: Poisson log-sum, log I(N), log p0 and the
    E(K) upper bound (NaN on delta == 0 lanes, the single-iteration exit)."""
    log_pois = _log_pois_cdf_sum(N, delta, lamb, cap_pois)
    log_I_N = _log_integral_direct(N, delta, math.log(lamb + beta), cap_int)
    p0, _ = _lprob2_given_logI(N, torch.zeros_like(N), delta, lamb, beta, log_pois, log_I_N)
    upper_bound = torch.exp(
        math.log(beta) + delta * lamb + torch.log(N + 1.0) - (math.log(lamb) + log_pois))
    return log_pois, log_I_N, p0, upper_bound


def _k_step_fast(N, delta, log_delta, log_pois, upper_bound, lg_N1,
                 lamb, beta, log_lb, threshold_Ek, state):
    """The production k iteration: every lgamma carried as a recurrence
    (lgamma(x+1) = lgamma(x) + log x), and the two positive-term sums,
    E(K) = sum k P(k) and the exit bound's partial sum, carried in linear
    f64 (both end in exp() in the reference, transcluster.hpp:232,238).
    Differs from the log-space oracle only in f64 rounding.

    Extended-regime exit, exact in f64: on a lane whose bound is unusable,
    once k P(k) falls below ulp(e_sum) every further add is a no-op, so
    stopping there returns the e_sum the full k-cap loop would (e_sum > 0
    keeps lanes whose first terms underflow running)."""
    k, e_sum, b_sum, log_I, lg_M1, lg_k1, log_k, done = state
    M = N + k
    log_I_next = _logaddexp(M * log_delta - lg_M1 - log_lb, log_I - log_lb)
    base = (N + 1.0) * math.log(lamb) + k * math.log(beta) + lg_M1 - lg_N1 - lg_k1
    base_pos = base - delta * beta - log_pois
    lprob_zero = base - (M + 1.0) * log_lb
    pos = delta > 0
    lp_k = torch.where(pos, base_pos + log_I_next, lprob_zero)
    lhs_k = torch.where(pos, base_pos, lprob_zero)

    e_term = torch.exp(lp_k + log_k)
    e_sum_new = e_sum + e_term
    b_sum_new = b_sum + torch.exp(lhs_k + log_k + delta * (lamb + beta) - (M + 1.0) * log_lb)
    tiny = (e_sum > 0.0) & (e_term <= e_sum * 1e-19)
    done_new = _exit_rule(done, k, upper_bound - b_sum_new, upper_bound, threshold_Ek, tiny)
    log_k1 = torch.log(k + 1.0)
    return (
        torch.where(done, k, k + 1.0),
        torch.where(done, e_sum, e_sum_new),
        torch.where(done, b_sum, b_sum_new),
        torch.where(done, log_I, log_I_next),
        torch.where(done, lg_M1, lg_M1 + torch.log(M + 1.0)),
        torch.where(done, lg_k1, lg_k1 + log_k1),
        torch.where(done, log_k, log_k1),
        done_new,
    )


def _k_block(lane, state, *, lamb, beta, threshold_Ek, n_steps):
    """Run ``n_steps`` k iterations; ``lane`` holds the per-lane invariants
    (N, delta, log_delta, log_pois, upper_bound, lg_N1)."""
    log_lb = math.log(lamb + beta)
    for _ in range(n_steps):
        state = _k_step_fast(*lane, lamb, beta, log_lb, threshold_Ek, state)
    return state


def _trans_dist_batch(N, delta, *, lamb, beta, threshold_Ek, cap_pois, cap_int):
    """Monolithic engine: seeds plus one batch-wide loop in log space until
    every lane is done.  Kept as the oracle of the blocked engine (the
    slowest lane stalls the whole batch here, so trans_dist does not use
    it).  Returns (log p0, E(K)) tensors."""
    log_pois, log_I_N, p0, upper_bound = _seed_batch(
        N, delta, lamb=lamb, beta=beta, cap_pois=cap_pois, cap_int=cap_int)
    log_lb = math.log(lamb + beta)
    ninf = torch.full_like(N, -math.inf)
    state = (torch.ones_like(N), ninf, ninf, log_I_N, torch.zeros_like(N, dtype=torch.bool))
    while not bool(state[4].all()):
        state = _k_step(N, delta, log_pois, upper_bound, lamb, beta, log_lb,
                        threshold_Ek, state)
    return p0, torch.exp(state[1])


def _sum_cap(peak: float, n_max: int) -> int:
    """Number of series terms so the truncated tail is ~e^-200 of the total."""
    cap = int(peak + 30.0 * math.sqrt(peak + 1.0) + 64.0)
    return max(1, min(n_max, cap))


def _pow2(n: int, lo: int = 64) -> int:
    """``n`` rounded up to a power of two, at least ``lo``: the series caps
    of tracs_tpu, whose truncation points the port keeps."""
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def _k_loop_blocked(lane, log_I0, lg_N2, *, lamb, beta, threshold_Ek):
    """The k loop's plain version, on any device: (E(K), exit k) of the
    lanes ``lane`` = (N, delta, log delta, log_pois, upper bound,
    lgamma(N+1)) from their seeded log I(N) ``log_I0`` and lgamma(N+2)
    ``lg_N2``.  Blocks of 8, 16, ... 512 ``_k_step_fast`` steps, dropping
    finished lanes between blocks, so a lane that needs the k cap does not
    stall the others; each block counts ``meta.k_blocks`` and its steps
    ``meta.k_steps``.  Per-lane math is elementwise, so the blocking does
    not change a lane's result."""
    N = lane[0]
    zeros = torch.zeros_like(N)
    # k, E(K) sum, bound sum, log I, lgamma(N+k+1), lgamma(k+1), log k at k=1
    state = [torch.ones_like(N), zeros, zeros.clone(), log_I0.clone(), lg_N2.clone(),
             zeros.clone(), zeros.clone()]
    eK = torch.empty_like(N)
    k_end = torch.empty_like(N)
    active = torch.arange(N.shape[0], device=N.device)
    n_steps = 8
    while active.numel():
        sub = tuple(x[active] for x in lane)
        blk = [x[active] for x in state] + [torch.zeros_like(active, dtype=torch.bool)]
        *blk, fin = _k_block(sub, tuple(blk), lamb=lamb, beta=beta,
                             threshold_Ek=threshold_Ek, n_steps=n_steps)
        for x, v in zip(state, blk):
            x[active] = v
        eK[active[fin]] = blk[1][fin]
        k_end[active[fin]] = blk[0][fin]
        active = active[~fin]
        count("meta.k_blocks")
        count("meta.k_steps", n_steps)
        n_steps = min(n_steps * 2, 512)
    return eK, k_end


def trans_k_loop(lane, log_I0, lg_N2, *, lamb, beta, threshold_Ek):
    """The k loop of sorted lanes: (E(K), exit k), float64 tensors on the
    lanes' device; the arguments as ``_k_loop_blocked``'s.  CPU tensors take
    ``_k_loop_blocked``; any others ``ops.kernels.trans_k_loop``, which
    launches the kernel ``csrc/trans_k_loop.cu`` once on CUDA tensors or
    raises.  Both refuse lanes the kernel does not take
    (``kernels.check_k_lanes``)."""
    if lane[0].device.type != "cpu":
        return kernels.trans_k_loop(lane, log_I0, lg_N2, lamb=lamb, beta=beta,
                                    threshold_Ek=threshold_Ek, k_cap=_K_CAP)
    kernels.check_k_lanes((*lane, log_I0, lg_N2))
    return _k_loop_blocked(lane, log_I0, lg_N2, lamb=lamb, beta=beta, threshold_Ek=threshold_Ek)


def _seed_lanes(sN, sd, *, lamb, beta, device):
    """The k loop's inputs for lanes sorted by (delta, N), given as host
    float64 arrays ``sN`` and ``sd``: ``(lane, log_I0, lg_N2, p0)`` on
    ``device``, as ``trans_k_loop`` takes them, and each lane's log p0.
    The loop-invariant seeds are made in chunks of ``_SEED_CHUNK`` lanes,
    each with series caps from its own peak."""
    N = torch.from_numpy(sN).to(device)
    delta = torch.from_numpy(sd).to(device)
    seeds = []
    for s in range(0, sN.shape[0], _SEED_CHUNK):
        e = min(sN.shape[0], s + _SEED_CHUNK)
        d_max, n_max = float(sd[s:e].max()), int(sN[s:e].max())
        cap_pois = _pow2(_sum_cap(lamb * d_max, n_max), lo=8)
        cap_int = _pow2(_sum_cap(d_max * (lamb + beta), n_max + _K_CAP), lo=8)
        seeds.append(_seed_batch(N[s:e], delta[s:e], lamb=lamb, beta=beta,
                                 cap_pois=cap_pois, cap_int=cap_int))
    log_pois, log_I0, p0, upper = (torch.cat(c) for c in zip(*seeds))
    lane = (N, delta, torch.log(delta), log_pois, upper, torch.lgamma(N + 1.0))
    return lane, log_I0, torch.lgamma(N + 2.0), p0


def trans_dist(snpdiff, datediff, lamb, beta, threshold_Ek=1e-6, *, device):
    """(log p0, E(K)) per pair as float64 numpy arrays (reference trans_dist,
    src/transcluster.hpp:240-287).  The reference's per-(N, delta) hash
    maps become a host-side unique, device batches and a scatter.

    Lanes sorted by (delta, N) are seeded in chunks of ``_SEED_CHUNK``, each
    with series caps from its own peak; then ``trans_k_loop`` runs each lane
    to its own exit: on a card one kernel launch, on the CPU blocks of
    steps.  Per-lane math is elementwise, so the result does not depend on
    the batching."""
    return _trans_dist_steps(snpdiff, datediff, lamb, beta, threshold_Ek, device=device)[:2]


def _trans_dist_steps(snpdiff, datediff, lamb, beta, threshold_Ek=1e-6, *, device):
    """``trans_dist``'s (log p0, E(K)) and, third, each pair's k-loop exit:
    the k after its last step, so E(K) sums the terms k' P(k') for
    1 <= k' < k.  Spans: ``meta.seed`` (the lanes' dedup, upload and seeds)
    and ``meta.k_loop`` (the k loop through the results' copies to the
    host).  On a card the launch counts one ``meta.k_blocks`` and its steps,
    its largest exit k less 1, ``meta.k_steps``; on the CPU the blocked
    engine counts its blocks and their steps."""
    device = resolve_device(device)
    snpdiff = np.asarray(snpdiff, dtype=np.int64)
    datediff = np.asarray(datediff, dtype=np.float64)
    if snpdiff.size == 0:
        return np.zeros(0), np.zeros(0), np.zeros(0)
    lamb, beta, threshold_Ek = float(lamb), float(beta), float(threshold_Ek)

    with span("meta.seed"):
        keys = np.stack([snpdiff.astype(np.float64), datediff], axis=1)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        order = np.lexsort((uniq[:, 0], uniq[:, 1]))
        m = order.shape[0]
        lane, log_I0, lg_N2, p0 = _seed_lanes(uniq[order, 0], uniq[order, 1], lamb=lamb,
                                              beta=beta, device=device)

    with span("meta.k_loop"):
        eK, k_end = trans_k_loop(lane, log_I0, lg_N2, lamb=lamb, beta=beta,
                                 threshold_Ek=threshold_Ek)
        p0_u, eK_u, k_u = np.empty(m), np.empty(m), np.empty(m)
        p0_u[order] = to_host(p0)
        eK_u[order] = to_host(eK)
        k_u[order] = to_host(k_end)
        if device.type != "cpu":
            count("meta.k_blocks")
            count("meta.k_steps", int(k_u.max()) - 1)
    return p0_u[inverse], eK_u[inverse], k_u[inverse]


class TransClusterCache:
    """Memo of (N, delta) -> (log p0, E(K)) across streamed row blocks (the
    streaming form of the reference's in-call hash maps,
    transcluster.hpp:245-246): a repeated pair costs one evaluation."""

    def __init__(self, lamb, beta, threshold_Ek=1e-6, *, device):
        self.lamb = float(lamb)
        self.beta = float(beta)
        self.threshold_Ek = float(threshold_Ek)
        self.device = resolve_device(device)
        self._memo: dict[tuple[int, float], tuple[float, float]] = {}

    def lookup(self, snpdiff, datediff):
        """(log p0, E(K)) float64 numpy arrays for the given pairs.  Spans:
        ``meta`` (the call) and ``meta.dedup`` (the host's dedup and memo
        work); the novel lanes handed to ``trans_dist`` count
        ``meta.lanes``."""
        with span("meta"):
            snpdiff = np.asarray(snpdiff, dtype=np.int64)
            datediff = np.asarray(datediff, dtype=np.float64)
            if snpdiff.size == 0:
                return np.zeros(0), np.zeros(0)
            with span("meta.dedup"):
                # dedup in numpy first: dict work is O(unique), not O(pairs)
                keys = np.stack([snpdiff.astype(np.float64), datediff], axis=1)
                uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
                tuples = [(int(n), float(d)) for n, d in uniq]
                novel = [t for t in tuples if t not in self._memo]
            if novel:
                count("meta.lanes", len(novel))
                p0, eK = trans_dist([t[0] for t in novel], [t[1] for t in novel],
                                    self.lamb, self.beta, self.threshold_Ek, device=self.device)
            with span("meta.dedup"):
                if novel:
                    self._memo.update(zip(novel, zip(p0.tolist(), eK.tolist())))
                vals = np.array([self._memo[t] for t in tuples], dtype=np.float64)
            return vals[inverse, 0], vals[inverse, 1]


# ---------------------------------------------------------------------------
# date glue (reference tracs/transcluster.py)
# ---------------------------------------------------------------------------

def sample_seconds(sample_dates, name: str) -> float:
    """Seconds from 1970-01-01 to the sampling date of ``name``, from the
    ``{name: (text, datetime.date)}`` metadata map; KeyError if it has no
    date."""
    return (sample_dates[name][1] - _EPOCH).total_seconds()


def calculate_trans_prob(sparse_snp_dist, sample_dates, K, lamb, beta,
                         samplenames=None, log=False, precision=0.01, *, device):
    """(p0, E(K), date difference in years) per pair of the sparse SNP
    distances ``(rows, cols, distances)``; p0 is a probability unless
    ``log``.  As in the reference (tracs/transcluster.py:8-41), ``K`` is
    accepted and unused, and every sample up to the largest index in a pair
    needs a date (KeyError otherwise)."""
    i, j = np.asarray(sparse_snp_dist[0]), np.asarray(sparse_snp_dist[1])
    d = np.asarray(sparse_snp_dist[2], dtype=np.int64)
    n = int(max(i.max(), j.max())) + 1
    secs = np.array([sample_seconds(sample_dates, samplenames[s]) for s in range(n)])
    years = np.abs(secs[i] - secs[j]) / SECONDS_IN_YEAR
    p0, eK = trans_dist(d, years, lamb, beta, precision, device=device)
    return (p0 if log else np.exp(p0)), eK, years
