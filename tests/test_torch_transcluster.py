"""The port's transmission model (tracs_tpu_torch/models/transcluster.py,
torch float64) against tracs_tpu.models.transcluster on the CPU.

Tolerances: the reference goldens at 1e-6, as tracs_tpu's own tests hold
them; the two engines against each other at rtol 1e-9 (both are float64,
but lgamma, exp and log come from different libraries and the sums may
round differently by a few ulps); the scalar API exactly, since it is the
same Python arithmetic.  The card-only tests hold the model on the card
against the model on the CPU at rtol 1e-9, and the k loop's kernel
(``csrc/trans_k_loop.cu``) against its plain version, the blocked engine,
on the same card.

jax is imported inside the tests that need it, so the card-only test runs
on a machine without it."""

import math

import numpy as np
import pytest
import torch

from tracs_tpu_torch.models import transcluster as tc
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.runtime import profiling

LAMB, BETA = 29.903, 73.0
DAY = 0.002737907006988508  # 1 day in years (86400 / 31556952)
CPU = torch.device("cpu")


@pytest.fixture
def jtc():
    """tracs_tpu.models.transcluster."""
    pytest.importorskip("jax")
    from tracs_tpu.models import transcluster

    return transcluster


def _lgamma_table(n):
    return [math.inf] + [math.lgamma(i) for i in range(1, n)]


def _sweep(seed, n):
    """Seeded (N, delta, lamb, beta) draws across the defined regime."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 80, size=n), rng.uniform(0.0, 1.5, size=n).round(4),
            rng.uniform(0.5, 40.0, size=n), rng.uniform(1.0, 100.0, size=n))


# -- the scalar API --

def test_lprob_k_given_N_sage_golden(jtc):
    # golden from a symbolic Sage integral (reference tests/test_llk.py:27-28)
    lgamma = _lgamma_table(20)
    lp, lhs = tc.lprob_k_given_N(7, 4, 0.16963, 3, 52, lgamma)
    assert abs(lp + 17.9565184209608) < 1e-6
    assert abs(lhs - 12.0861694243766) < 1e-6
    assert (lp, lhs) == jtc.lprob_k_given_N(7, 4, 0.16963, 3, 52, lgamma)


@pytest.mark.parametrize("N,k,delta", [(5, 3, 0.0), (0, 0, 0.3), (12, 7, 1.1), (40, 0, 0.01)])
def test_scalar_api_equals_reference(jtc, N, k, delta):
    lgamma = _lgamma_table(80)
    assert tc.lprob_k_given_N(N, k, delta, LAMB, BETA, lgamma) == \
        jtc.lprob_k_given_N(N, k, delta, LAMB, BETA, lgamma)
    if delta > 0:
        assert tc.upper_bound_E(delta, LAMB, BETA, N) == jtc.upper_bound_E(delta, LAMB, BETA, N)
        want = jtc.expected_k(N, delta, LAMB, BETA, 0.01)
        assert tc.expected_k(N, delta, LAMB, BETA, 0.01, device="cpu") == \
            pytest.approx(want, rel=1e-9)


# -- the engine --

def test_trans_dist_reference_goldens(jtc):
    # the end-to-end distance-stage goldens (reference tests/test_trans_distance.py:29-43)
    p0, eK = tc.trans_dist([0, 2], [DAY, DAY], LAMB, BETA, 0.01, device="cpu")
    assert p0.dtype == eK.dtype == np.float64
    assert abs(np.exp(p0[0]) - 0.23794988406662973) < 1e-6
    assert abs(np.exp(p0[1]) - 0.024467137572328577) < 1e-6
    assert abs(eK[0] - 2.6335200453700187) < 1e-6
    assert abs(eK[1] - 7.315670110063259) < 1e-6
    jp0, jeK = jtc.trans_dist([0, 2], [DAY, DAY], LAMB, BETA, 0.01)
    np.testing.assert_allclose(p0, jp0, rtol=1e-9)
    np.testing.assert_allclose(eK, jeK, rtol=1e-9)


def test_trans_dist_delta_zero_quirk(jtc):
    """delta = 0: the bound is NaN, the loop exits after k=1 and
    E(K) = P(k=1 | N)."""
    p0, eK = tc.trans_dist([3, 0, 17], [0.0, 0.0, 0.0], LAMB, BETA, 0.01, device="cpu")
    lgamma = _lgamma_table(50)
    for n, p, e in zip([3, 0, 17], p0, eK):
        assert abs(e - np.exp(tc.lprob_k_given_N(n, 1, 0.0, LAMB, BETA, lgamma)[0])) < 1e-12
        assert abs(p - tc.lprob_k_given_N(n, 0, 0.0, LAMB, BETA, lgamma)[0]) < 1e-12
    jp0, jeK = jtc.trans_dist([3, 0, 17], [0.0, 0.0, 0.0], LAMB, BETA, 0.01)
    np.testing.assert_allclose(p0, jp0, rtol=1e-9)
    np.testing.assert_allclose(eK, jeK, rtol=1e-9)


def test_trans_dist_empty():
    p0, eK = tc.trans_dist([], [], LAMB, BETA, device="cpu")
    assert len(p0) == 0 and len(eK) == 0


def test_trans_dist_memoised_scatter():
    d = [5, 0, 5, 2, 0]
    dd = [0.1, 0.2, 0.1, 0.2, 0.2]
    p0, eK = tc.trans_dist(d, dd, LAMB, BETA, 0.01, device="cpu")
    assert p0[0] == p0[2] and eK[0] == eK[2]
    assert p0[1] == p0[4] and eK[1] == eK[4]
    assert len(p0) == len(eK) == 5
    single = [tc.trans_dist([n], [t], LAMB, BETA, 0.01, device="cpu") for n, t in zip(d, dd)]
    np.testing.assert_allclose(eK, [s[1][0] for s in single], rtol=1e-12)


def test_large_N_stability(jtc):
    p0, eK = tc.trans_dist([20000], [0.5], LAMB, BETA, 0.01, device="cpu")
    assert np.isfinite(p0[0]) and np.isfinite(eK[0]) and p0[0] < 0
    jp0, jeK = jtc.trans_dist([20000], [0.5], LAMB, BETA, 0.01)
    np.testing.assert_allclose(p0, jp0, rtol=1e-9)
    np.testing.assert_allclose(eK, jeK, rtol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trans_dist_sweep_matches_reference(jtc, seed):
    """(N, delta, lamb, beta) drawn from a seed, delta = 0 lanes and
    repeated lanes included, against the JAX engine at rtol 1e-9."""
    N, delta, lamb, beta = _sweep(seed, 40)
    delta[::9] = 0.0
    for k in range(0, 40, 10):
        sl = slice(k, k + 10)
        got = tc.trans_dist(N[sl], delta[sl], lamb[k], beta[k], 0.01, device="cpu")
        want = jtc.trans_dist(N[sl], delta[sl], lamb[k], beta[k], 0.01)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-9)


def test_variant_equivalence():
    """The scalar first variant and the vectorised engine agree on log p0
    (k = 0) across a parameter sweep."""
    lgamma = _lgamma_table(200)
    N, delta, lamb, beta = _sweep(7, 25)
    for n, d, l, b in zip(N, delta + 0.001, lamb, beta):
        lp_v1, _ = tc.lprob_k_given_N(n, 0, d, l, b, lgamma)
        p0, _ = tc.trans_dist([n], [d], l, b, 0.01, device="cpu")
        assert abs(p0[0] - lp_v1) < 1e-9, (n, d, l, b)


def test_monolithic_oracle_matches_blocked_engine():
    """_trans_dist_batch (one batch-wide loop in log space) against the
    blocked, compacting engine, in the defined regime."""
    N, delta, _, _ = _sweep(3, 30)
    delta[::7] = 0.0
    cap_p = tc._pow2(tc._sum_cap(LAMB * float(delta.max()), int(N.max())), lo=8)
    cap_i = tc._pow2(tc._sum_cap(float(delta.max()) * (LAMB + BETA),
                                 int(N.max()) + tc._K_CAP), lo=8)
    p0_m, eK_m = tc._trans_dist_batch(
        torch.tensor(N, dtype=torch.float64), torch.tensor(delta), lamb=LAMB, beta=BETA,
        threshold_Ek=0.01, cap_pois=cap_p, cap_int=cap_i)
    p0, eK = tc.trans_dist(N, delta, LAMB, BETA, 0.01, device="cpu")
    np.testing.assert_allclose(p0, p0_m.numpy(), rtol=1e-12)
    np.testing.assert_allclose(eK, eK_m.numpy(), rtol=1e-9)


def test_extended_regime_bound_guard(jtc):
    """lamb*delta >> N: the bound (~1e61) is unusable, exact math runs to
    the k cap and E(K) lands near the transmission-rate expectation; the
    blocked engine matches the monolithic oracle and the JAX engine."""
    p0, eK = tc.trans_dist([27], [7.3101], LAMB, BETA, device="cpu")
    assert 400 < eK[0] < 700
    cap_p = tc._sum_cap(LAMB * 7.3101, 27)
    cap_i = tc._sum_cap(7.3101 * (LAMB + BETA), 27 + tc._K_CAP)
    p0_m, eK_m = tc._trans_dist_batch(
        torch.tensor([27.0], dtype=torch.float64), torch.tensor([7.3101], dtype=torch.float64),
        lamb=LAMB, beta=BETA, threshold_Ek=1e-6, cap_pois=cap_p, cap_int=cap_i)
    np.testing.assert_allclose(eK, eK_m.numpy(), rtol=1e-7)
    np.testing.assert_allclose(p0, p0_m.numpy(), rtol=1e-9)
    jp0, jeK = jtc.trans_dist([27], [7.3101], LAMB, BETA)
    np.testing.assert_allclose(p0, jp0, rtol=1e-9)
    np.testing.assert_allclose(eK, jeK, rtol=1e-9)


def test_extended_regime_tiny_term_exit(jtc):
    """The tiny-term exit on bound-unusable lanes returns the E(K) of the
    full 10000-step loop, emulated step by step in numpy (libm exp/log
    differ from torch's by ~1 ulp, so rtol 1e-11, not ==)."""
    from scipy.special import gammaln

    cases = [(27, 7.3101), (3, 9.99), (120, 6.5)]
    for N, delta in cases:
        assert tc.upper_bound_E(delta, LAMB, BETA, N) * 1e-12 >= 0.01  # unusable
    _, eK = tc.trans_dist([c[0] for c in cases], [c[1] for c in cases], LAMB, BETA, 0.01,
                          device="cpu")
    _, jeK = jtc.trans_dist([c[0] for c in cases], [c[1] for c in cases], LAMB, BETA, 0.01)
    np.testing.assert_allclose(eK, jeK, rtol=1e-9)
    log_lb = math.log(LAMB + BETA)
    for (N, delta), got in zip(cases, eK):
        i = np.arange(0, N + 1)
        log_pois = np.logaddexp.reduce(i * np.log(LAMB * delta) - gammaln(i + 1.0))
        log_I = np.logaddexp.reduce(i * np.log(delta) - gammaln(i + 1.0) - (N - i + 1.0) * log_lb)
        e_sum = 0.0
        lg_N1 = gammaln(N + 1.0)
        for k in range(1, tc._K_CAP):
            M = N + k
            log_I = np.logaddexp(M * np.log(delta) - gammaln(M + 1.0) - log_lb, log_I - log_lb)
            lp = ((N + 1.0) * math.log(LAMB) + k * math.log(BETA) + gammaln(M + 1.0) - lg_N1
                  - gammaln(k + 1.0) - delta * BETA - log_pois + log_I)
            e_sum += math.exp(lp + math.log(k))
        np.testing.assert_allclose(got, e_sum, rtol=1e-11)


# -- the helpers whose float semantics the engine rests on --

def test_logaddexp_infinities_and_nan():
    ninf, nan = -math.inf, math.nan
    a = torch.tensor([ninf, ninf, 0.0, nan, math.inf, 1.0], dtype=torch.float64)
    b = torch.tensor([ninf, 2.0, ninf, 1.0, math.inf, 1.0], dtype=torch.float64)
    got = tc._logaddexp(a, b).tolist()
    assert got[:3] == [ninf, 2.0, 0.0] and math.isnan(got[3]) and got[4] == math.inf
    assert got[5] == pytest.approx(1.0 + math.log(2.0), rel=1e-15)


def test_masked_logsumexp_propagates_nan(jtc):
    """A NaN in an unmasked term propagates; a masked one does not; an
    all-masked row gives -inf; otherwise it equals JAX's to rtol 1e-14."""
    import jax.numpy as jnp

    terms = np.array([[0.0, 1.0, np.nan], [0.0, np.nan, 2.0], [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    mask = np.array([[True, True, False], [True, True, True], [False] * 3, [True, False, True]])
    got = tc._masked_logsumexp(torch.from_numpy(terms), torch.from_numpy(mask)).numpy()
    want = np.asarray(jtc._masked_logsumexp(jnp.asarray(terms), jnp.asarray(mask)))
    assert math.isnan(got[1]) and got[2] == -math.inf
    np.testing.assert_allclose(got[[0, 3]], want[[0, 3]], rtol=1e-14)
    assert math.isnan(want[1]) and want[2] == -math.inf


# -- the cache and the date glue --

def test_cache_matches_trans_dist_and_memoises(monkeypatch):
    cache = tc.TransClusterCache(LAMB, BETA, 0.01, device="cpu")
    d = np.array([5, 0, 5, 2, 0])
    dd = np.array([0.1, 0.2, 0.1, 0.2, 0.2])
    p0, eK = cache.lookup(d, dd)
    want = tc.trans_dist(d, dd, LAMB, BETA, 0.01, device="cpu")
    np.testing.assert_array_equal(p0, want[0])
    np.testing.assert_array_equal(eK, want[1])
    calls = []
    real = tc.trans_dist
    monkeypatch.setattr(tc, "trans_dist", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    p0b, _ = cache.lookup([2, 9, 5], [0.2, 0.3, 0.1])
    assert [list(c) for c in calls] == [[9]]  # only the novel (N, delta) is evaluated
    assert p0b[0] == p0[3] and p0b[2] == p0[0]
    assert cache.lookup([], [])[0].size == 0


def _dates(*days):
    from datetime import date

    return {f"s{k}": (d, date.fromisoformat(d)) for k, d in enumerate(days)}


def test_calculate_trans_prob_matches_reference(jtc):
    dates = _dates("2019-01-14", "2019-01-15", "2019-03-01", "2019-01-14")
    names = list(dates)
    sparse = [[0, 0, 1, 2], [1, 3, 2, 3], [2, 0, 5, 11]]
    for log in (False, True):
        got = tc.calculate_trans_prob(sparse, dates, 100, LAMB, BETA, samplenames=names,
                                      log=log, precision=0.01, device="cpu")
        want = jtc.calculate_trans_prob(sparse, dates, 100, LAMB, BETA, samplenames=names,
                                        log=log, precision=0.01)
        np.testing.assert_array_equal(got[2], want[2])  # date difference: exact
        np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-9)
    assert abs(got[2][0] - DAY) < 1e-15
    p0, _, _ = tc.calculate_trans_prob([[0], [1], [2]], dates, 100, LAMB, BETA,
                                       samplenames=names, device="cpu")
    assert abs(p0[0] - 0.024467137572328577) < 1e-6


def test_calculate_trans_prob_missing_date_raises():
    dates = _dates("2019-01-14", "2019-01-15")
    with pytest.raises(KeyError):
        tc.calculate_trans_prob([[0], [2], [1]], dates, 100, LAMB, BETA,
                                samplenames=["s0", "s1", "nodate"], device="cpu")


# -- the k loop's dispatch on the CPU --

def _lanes(N, delta):
    """Seeded lanes as ``_trans_dist_steps`` hands them to ``trans_k_loop``."""
    lane, log_I0, lg_N2, _ = tc._seed_lanes(np.array(N, dtype=np.float64),
                                            np.array(delta, dtype=np.float64),
                                            lamb=LAMB, beta=BETA, device=CPU)
    return lane, log_I0, lg_N2


def test_cpu_lanes_never_load_the_kernel(monkeypatch):
    """CPU lanes take the blocked engine: the kernel library is never built
    or loaded, and no kernel launch is counted."""
    from tracs_tpu_torch.runtime import build

    def refuse(*a, **k):
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(build, "load_cuda_library", refuse)
    monkeypatch.setattr(kernels, "_kernel_entry", refuse)
    before = profiling.counter("kernel.launches.trans_k_loop")
    p0, eK = tc.trans_dist([0, 2, 27, 5], [DAY, DAY, 7.3101, 0.0], LAMB, BETA, 0.01,
                           device="cpu")
    assert abs(eK[1] - 7.315670110063259) < 1e-6
    assert profiling.counter("kernel.launches.trans_k_loop") == before


@pytest.mark.parametrize("N,delta,blocks,steps", [
    (5, 0.0, 1, 8),                # delta == 0: exits after k = 1, one block of 8
    (20000, 0.5, 25, 10232),       # the k cap: 504 steps, then 19 blocks of 512
])
def test_cpu_k_counters_keep_their_blocked_values(N, delta, blocks, steps):
    """On the CPU ``meta.k_blocks`` counts each block of the blocked engine
    and ``meta.k_steps`` its steps, as before the kernel existed."""
    b0 = profiling.counter("meta.k_blocks")
    s0 = profiling.counter("meta.k_steps")
    _, _, k = tc._trans_dist_steps([N], [delta], LAMB, BETA, 0.01, device="cpu")
    assert k[0] == (2.0 if delta == 0 else tc._K_CAP)
    assert profiling.counter("meta.k_blocks") - b0 == blocks
    assert profiling.counter("meta.k_steps") - s0 == steps


def test_cpu_trans_k_loop_is_the_blocked_engine_and_keeps_its_inputs():
    lane, log_I0, lg_N2 = _lanes([0, 3, 40, 27], [0.0, 0.1, 1.3, 7.3101])
    kept = [t.clone() for t in (*lane, log_I0, lg_N2)]
    got = tc.trans_k_loop(lane, log_I0, lg_N2, lamb=LAMB, beta=BETA, threshold_Ek=0.01)
    want = tc._k_loop_blocked(lane, log_I0, lg_N2, lamb=LAMB, beta=BETA, threshold_Ek=0.01)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for t, k in zip((*lane, log_I0, lg_N2), kept):
        torch.testing.assert_close(t, k, rtol=0, atol=0, equal_nan=True)


def _bad_lanes(kind):
    lane, log_I0, lg_N2 = _lanes([0, 3, 40, 27], [0.0, 0.1, 1.3, 7.3101])
    lane = list(lane)
    if kind == "float32":
        lane[1] = lane[1].float()
    elif kind == "strided":
        lane[2] = torch.stack([lane[2], lane[2]], dim=1)[:, 0]
    elif kind == "length":
        log_I0 = log_I0[:3]
    elif kind == "2-d":
        lane[0] = lane[0][None, :]
    elif kind == "meta":
        lane = [t.to("meta") for t in lane]
        log_I0, lg_N2 = log_I0.to("meta"), lg_N2.to("meta")
    return tuple(lane), log_I0, lg_N2


@pytest.mark.parametrize("kind,error", [("float32", TypeError), ("strided", ValueError),
                                        ("length", ValueError), ("2-d", ValueError),
                                        ("meta", ValueError)])
def test_trans_k_loop_refuses_what_the_kernel_does_not_take(kind, error):
    lane, log_I0, lg_N2 = _bad_lanes(kind)
    with pytest.raises(error):
        tc.trans_k_loop(lane, log_I0, lg_N2, lamb=LAMB, beta=BETA, threshold_Ek=0.01)


def test_kernel_wrapper_refuses_cpu_lanes():
    """The kernel's wrapper takes CUDA lanes only; the model keeps CPU lanes
    on the blocked engine."""
    lane, log_I0, lg_N2 = _lanes([0, 3, 40, 27], [0.0, 0.1, 1.3, 7.3101])
    with pytest.raises(ValueError, match="runs on cuda"):
        kernels.trans_k_loop(lane, log_I0, lg_N2, lamb=LAMB, beta=BETA, threshold_Ek=0.01,
                             k_cap=tc._K_CAP)


def test_trans_k_loop_empty_on_the_cpu():
    e = torch.zeros(0, dtype=torch.float64)
    eK, k = tc.trans_k_loop((e,) * 6, e, e, lamb=LAMB, beta=BETA, threshold_Ek=0.01)
    assert eK.shape == k.shape == (0,)


# -- on the card --

@pytest.mark.cuda
def test_trans_dist_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    N, delta, _, _ = _sweep(5, 400)
    delta[::11] = 0.0
    N = np.concatenate([N, [27, 3, 20000]])
    delta = np.concatenate([delta, [7.3101, 9.99, 0.5]])
    got = tc.trans_dist(N, delta, LAMB, BETA, 0.01, device="cuda")
    want = tc.trans_dist(N, delta, LAMB, BETA, 0.01, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9)
    p0, eK = tc.trans_dist([0, 2], [DAY, DAY], LAMB, BETA, 0.01, device="cuda")
    assert abs(np.exp(p0[0]) - 0.23794988406662973) < 1e-6
    assert abs(eK[1] - 7.315670110063259) < 1e-6


def _grid_lanes():
    N, d = np.meshgrid(np.arange(0, 301, 4), np.linspace(0.0, 3.0, 41))
    return N.ravel(), d.ravel().round(6)


def _extended_lanes():
    # the bound is unusable (upper * 1e-12 >= threshold): the tiny-term exit
    return np.array([27, 3, 120, 0, 60]), np.array([7.3101, 9.99, 6.5, 3.0, 5.5])


def _k_loop_cases():
    gN, gd = _grid_lanes()
    zN = np.arange(0, 300, 7)
    eN, ed = _extended_lanes()
    return {
        "grid": (gN, gd),
        "delta0": (zN, np.zeros(zN.shape)),
        "extended": (eN, ed),
        "k_cap": (np.array([20000, 40]), np.array([0.5, 0.2])),
        "one_lane": (np.array([17]), np.array([0.35])),
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.01, 1e-6])
@pytest.mark.parametrize("case", ["grid", "delta0", "extended", "k_cap", "one_lane"])
def test_k_loop_kernel_matches_blocked_engine_on_the_card(cuda_device, case, threshold):
    """The kernel (one launch a call) against the plain blocked engine on the
    same card and the same seeded lanes: the same exit k on every lane, p0
    and E(K) at rtol 1e-12.  They are also bit for bit: the kernel rounds
    each operation as the plain path's one-operation kernels do (no FMA
    contraction, the same CUDA math functions), so the E(K) sums are
    asserted equal too.  p0 comes from the seeds, which both engines share.
    The launch counts one ``meta.k_blocks`` and its largest exit k less 1
    ``meta.k_steps``."""
    N, delta = _k_loop_cases()[case]
    keys = np.unique(np.stack([N, delta], axis=1).astype(np.float64), axis=0)
    sN, sd = keys[np.lexsort((keys[:, 0], keys[:, 1]))].T.copy()
    before = {c: profiling.counter(c) for c in
              ("kernel.launches.trans_k_loop", "meta.k_blocks", "meta.k_steps")}
    p0, eK, k = tc._trans_dist_steps(sN, sd, LAMB, BETA, threshold, device=cuda_device)
    assert profiling.counter("kernel.launches.trans_k_loop") == before[
        "kernel.launches.trans_k_loop"] + 1
    assert profiling.counter("meta.k_blocks") == before["meta.k_blocks"] + 1
    assert profiling.counter("meta.k_steps") - before["meta.k_steps"] == int(k.max()) - 1
    lane, log_I0, lg_N2, wp0 = tc._seed_lanes(sN, sd, lamb=LAMB, beta=BETA, device=cuda_device)
    weK, wk = (t.cpu().numpy() for t in tc._k_loop_blocked(
        lane, log_I0, lg_N2, lamb=LAMB, beta=BETA, threshold_Ek=threshold))
    np.testing.assert_array_equal(k, wk)
    np.testing.assert_allclose(p0, wp0.cpu().numpy(), rtol=1e-12)
    np.testing.assert_allclose(eK, weK, rtol=1e-12)
    np.testing.assert_array_equal(eK, weK)
    if case == "delta0":
        assert np.all(k == 2.0)
    if case == "k_cap":
        assert k[np.argmax(sN)] == tc._K_CAP


@pytest.mark.cuda
def test_k_loop_kernel_empty_input(cuda_device):
    launches = profiling.counter("kernel.launches.trans_k_loop")
    p0, eK, k = tc._trans_dist_steps([], [], LAMB, BETA, 0.01, device=cuda_device)
    assert p0.size == eK.size == k.size == 0
    e = torch.zeros(0, dtype=torch.float64, device=cuda_device)
    got = tc.trans_k_loop((e,) * 6, e, e, lamb=LAMB, beta=BETA, threshold_Ek=0.01)
    assert got[0].shape == got[1].shape == (0,)
    assert profiling.counter("kernel.launches.trans_k_loop") == launches


@pytest.mark.cuda
def test_cache_lookup_launches_the_kernel_once(cuda_device):
    """Each lookup with novel lanes is one launch; a repeated lookup none."""
    cache = tc.TransClusterCache(LAMB, BETA, 0.01, device=cuda_device)
    N, delta = _grid_lanes()
    launches = profiling.counter("kernel.launches.trans_k_loop")
    p0, eK = cache.lookup(N, delta)
    cache.lookup(N, delta)
    assert profiling.counter("kernel.launches.trans_k_loop") == launches + 1
    want = tc.trans_dist(N, delta, LAMB, BETA, 0.01, device="cpu")
    np.testing.assert_allclose(p0, want[0], rtol=1e-9)
    np.testing.assert_allclose(eK, want[1], rtol=1e-9)


def test_cuda_without_card_raises():
    """The model runs on the device it is given: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from tracs_tpu_torch.runtime.device import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        tc.trans_dist([1], [0.1], LAMB, BETA, device="cuda")
    with pytest.raises(DeviceUnavailableError):
        tc.TransClusterCache(LAMB, BETA, device="cuda")
