"""The port's Dirichlet-multinomial model (tracs_tpu_torch/models/dirichlet.py)
against tracs_tpu's on the CPU: the same numpy counts, made from a seed,
through both packages.

Tolerances: the alphas and the posteriors at rtol 1e-9 (two float64 engines:
their digamma and their order of summation differ by ulps, and the fit stops
at the same iteration); the R MGLM golden at the reference test's own 1e-3;
the posterior rule against a row-by-row walk exactly (the same IEEE
operations on the same operands)."""

import numpy as np
import pytest
import torch

from tracs_tpu_torch.models import dirichlet as port
from tracs_tpu_torch.runtime.device import DeviceUnavailableError


def _jref():
    """tracs_tpu's model; imported by the tests that compare with it, so that
    the card-only test below runs on a machine without jax."""
    pytest.importorskip("jax")
    from tracs_tpu.models import dirichlet

    return dirichlet


RTOL = 1e-9

R_COUNTS = np.array(
    [[1, 19, 73], [1, 19, 90], [0, 33, 53], [5, 19, 91], [3, 17, 57],
     [3, 13, 77], [5, 6, 89], [1, 23, 85], [2, 29, 67], [7, 6, 99],
     [0, 17, 96], [0, 10, 86], [4, 5, 85], [6, 25, 65], [0, 5, 86],
     [0, 16, 91], [23, 14, 73], [4, 9, 96], [2, 19, 71], [9, 24, 78]]
)
R_RESULT = np.array([20.8156311152126, 4.38181182238621, 0.889048781117318])


def _pileup_counts(seed, rows=4000, depth=40, mixed=0.03, zero=0.1):
    """Counts as a pileup gives them: one major allele a row at a Poisson
    depth, a few error reads, some mixed sites with two alleles, some rows
    without coverage."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((rows, 4))
    major = rng.integers(0, 4, size=rows)
    counts[np.arange(rows), major] = rng.poisson(depth, size=rows)
    err = rng.random(rows) < 0.2
    counts[err, (major[err] + 1) % 4] += rng.integers(1, 3, size=int(err.sum()))
    mix = rng.random(rows) < mixed
    counts[mix, (major[mix] + 2) % 4] += rng.poisson(depth // 2, size=int(mix.sum()))
    counts[rng.random(rows) < zero] = 0
    return counts


def fit_with_iterations(counts, **kw):
    """(alphas, steps) of ``find_dirichlet_priors``: the steps its fixed-point
    loop took, 0 when it was never entered."""
    steps = []
    loop = port._fit

    def counting(*args):
        out = loop(*args)
        steps.append(out[1])
        return out

    port._fit = counting
    try:
        alphas = port.find_dirichlet_priors(counts, **kw)
    finally:
        port._fit = loop
    return alphas, sum(steps)


def posteriors_walk(counts, alphas, keep, expected):
    """Row-by-row walk over a stable descending argsort that advances the
    alpha at value boundaries: the rule ``calculate_posteriors`` vectorises."""
    alphas = sorted(alphas, reverse=True)
    a0 = sum(alphas)
    out = np.zeros_like(counts, dtype=float)
    for i, row in enumerate(counts):
        denom = row.sum()
        idx = sorted(range(len(row)), key=lambda j: -row[j])
        ai = 0
        for m, j in enumerate(idx):
            if denom <= 0:
                out[i, j] = alphas[0] / a0
            else:
                out[i, j] = (row[j] + alphas[ai]) / (denom + a0)
                if m < len(row) - 1 and row[idx[m]] != row[idx[m + 1]]:
                    ai += 1
        for j in range(len(row)):
            if out[i, j] <= expected:
                out[i, j] = expected if (keep and row[j] > 0) else 0.0
    return out


# -- the fit --

@pytest.mark.parametrize("method,tol", [("FP", 1e-3), ("LOO", 1e-6)])
def test_golden_vs_R_MGLM(method, tol):
    """The golden of tests/test_dirichlet.py (R's MGLM::MGLMfit; for LOO the
    fixed point of the original numpy implementation), at that file's
    tolerances, and the same call through tracs_tpu at rtol 1e-9."""
    want = R_RESULT if method == "FP" else np.array([19.39792305, 4.12033856, 0.82532347])
    got = port.find_dirichlet_priors(R_COUNTS, tol=1e-10, method=method, device="cpu")
    assert np.max(np.abs(got - want)) < tol
    assert np.max(got - R_RESULT) < 1e-3
    np.testing.assert_allclose(
        got, _jref().find_dirichlet_priors(R_COUNTS, tol=1e-10, method=method), rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", ["FPI", "LOO", "anything else"])
@pytest.mark.parametrize("error_filt", [None, 0.05])
def test_priors_match_reference(seed, method, error_filt):
    counts = _pileup_counts(seed)
    kw = dict(method=method, error_filt_threshold=error_filt)
    want = _jref().find_dirichlet_priors(counts, **kw)
    got, iterations = fit_with_iterations(counts, device="cpu", **kw)
    assert got.shape == (4,) and got.dtype == np.float64 and np.all(np.diff(got) <= 0)
    assert 1 < iterations < 1000
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if method == "anything else":  # any method but "LOO" is FPI
        np.testing.assert_array_equal(
            got, port.find_dirichlet_priors(counts, method="FPI", error_filt_threshold=error_filt,
                                            device="cpu"))


@pytest.mark.parametrize("max_iter,tol", [(1, 1e-5), (7, 1e-5), (1000, 1e-12)])
def test_priors_iteration_limits_match_reference(max_iter, tol):
    """A loop cut by ``max_iter`` stops where the reference's stops: FPI's
    floor applies to the steps that are followed by another."""
    counts = _pileup_counts(5, rows=600)
    want = _jref().find_dirichlet_priors(counts, max_iter=max_iter, tol=tol)
    got, iterations = fit_with_iterations(counts, max_iter=max_iter, tol=tol, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert iterations <= max_iter


@pytest.mark.parametrize("polymorphic", [0, 5, 6])
def test_few_polymorphic_rows_sentinel(polymorphic):
    """Fewer than 6 polymorphic rows give the fixed vector [0, 0, 0, 1.0]."""
    counts = np.zeros((100, 4))
    counts[:, 0] = 50
    counts[:polymorphic, 1] = 3
    counts[:polymorphic, 2] = 1
    got, iterations = fit_with_iterations(counts, device="cpu")
    want = _jref().find_dirichlet_priors(counts)
    if polymorphic < 6:
        assert np.array_equal(got, [0, 0, 0, 1.0]) and np.array_equal(want, got)
        assert iterations == 0
    else:
        assert len(got) == 4 and iterations > 0
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_error_filt_threshold_zeroes_minor_alleles():
    rng = np.random.default_rng(3)
    counts = np.zeros((50, 4))
    counts[:, 0] = 100
    counts[:, 1] = rng.integers(20, 40, size=50)
    counts[:, 2] = 1  # a noise allele below the threshold
    before = counts.copy()
    a_filt = port.find_dirichlet_priors(counts, error_filt_threshold=0.05, device="cpu")
    assert np.array_equal(counts, before)  # the filter works on a copy
    counts2 = counts.copy()
    counts2[:, 2] = 0
    assert np.allclose(a_filt, port.find_dirichlet_priors(counts2, device="cpu"))
    np.testing.assert_allclose(
        a_filt, _jref().find_dirichlet_priors(counts, error_filt_threshold=0.05), rtol=RTOL)


def test_priors_take_a_tensor_and_leave_it_alone():
    counts = _pileup_counts(7, rows=500)
    t = torch.from_numpy(counts.copy())
    got = port.find_dirichlet_priors(t, error_filt_threshold=0.05, device="cpu")
    assert np.array_equal(t.numpy(), counts)
    np.testing.assert_array_equal(
        got, port.find_dirichlet_priors(counts, error_filt_threshold=0.05, device="cpu"))


# -- the posteriors --

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("keep", [False, True])
def test_posteriors_match_walk_and_reference(seed, keep):
    """The cases of tests/test_dirichlet.py::test_posteriors_matches_cpp_walk:
    small counts with many ties and zero-coverage rows."""
    rng = np.random.default_rng(12345 + seed)
    counts = rng.integers(0, 6, size=(500, 4)).astype(float)
    counts[rng.random(500) < 0.15] = 0
    alphas = [2.0, 0.5, 0.13, 0.02]
    got = port.calculate_posteriors(counts, alphas, keep, 0.11, device="cpu")
    assert got.dtype == np.float64 and got.flags.writeable
    assert np.array_equal(got, posteriors_walk(counts, np.array(alphas), keep, 0.11))
    np.testing.assert_allclose(got, _jref().calculate_posteriors(counts, alphas, keep, 0.11),
                               rtol=RTOL)


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("whose_alphas", ["reference", "port"])
def test_posteriors_on_fitted_alphas_match_reference(keep, whose_alphas):
    """The fitted alphas of either package through the port's posterior rule:
    with tracs_tpu's alphas only the rule can differ, with the port's own the
    fit's ulps come in too."""
    counts = _pileup_counts(11)
    ref_alphas = _jref().find_dirichlet_priors(counts, error_filt_threshold=0.01)
    alphas = ref_alphas if whose_alphas == "reference" else port.find_dirichlet_priors(
        counts, error_filt_threshold=0.01, device="cpu")
    expected = 5 / 40
    want = _jref().calculate_posteriors(counts, ref_alphas, keep, expected)
    got = port.calculate_posteriors(counts, alphas, keep, expected, device="cpu")
    # a posterior that ties with the threshold could fall on either side in
    # two engines; none does on these counts, so the zero patterns are equal
    assert np.array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_posteriors_tie_handling():
    counts = np.array([[5.0, 5.0, 3.0, 3.0], [7.0, 1.0, 1.0, 0.0]])
    alphas = [4.0, 2.0, 1.0, 0.5]
    got = port.calculate_posteriors(counts, alphas, False, 0.0, device="cpu")
    assert np.array_equal(got, posteriors_walk(counts, np.array(alphas), False, 0.0))
    assert np.array_equal(got, _jref().calculate_posteriors(counts, alphas, False, 0.0))
    a0 = 7.5  # both 5s use alpha[0] = 4, both 3s alpha[1] = 2
    assert got[0, 0] == got[0, 1] == (5 + 4) / (16 + a0)
    assert got[0, 2] == got[0, 3] == (3 + 2) / (16 + a0)


@pytest.mark.parametrize("keep,expected,value", [(False, 0.1, 0.5), (True, 0.6, 0.0)])
def test_posteriors_zero_coverage_rows(keep, expected, value):
    """alpha_max / alpha_0 everywhere; at or below the threshold it is zeroed,
    and ``keep`` cannot rescue it: the raw counts are 0."""
    got = port.calculate_posteriors(np.zeros((3, 4)), [1.0, 0.5, 0.25, 0.25], keep, expected,
                                    device="cpu")
    assert np.all(got == value)


def test_posteriors_unsorted_alphas_and_three_alleles():
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 9, size=(200, 3)).astype(float)
    alphas = [0.3, 5.0, 1.1]
    got = port.calculate_posteriors(counts, alphas, True, 0.2, device="cpu")
    assert np.array_equal(got, posteriors_walk(counts, np.array(alphas), True, 0.2))
    np.testing.assert_allclose(got, _jref().calculate_posteriors(counts, alphas, True, 0.2),
                               rtol=RTOL)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_posteriors_row_chunks_agree(monkeypatch, chunk):
    """Rows are independent: any chunking gives the same matrix."""
    counts = _pileup_counts(13, rows=100)
    alphas = [3.0, 0.4, 0.1, 0.05]
    whole = port.calculate_posteriors(torch.from_numpy(counts), alphas, True, 0.1, device="cpu")
    monkeypatch.setattr(port, "_POSTERIOR_CHUNK_ROWS", chunk)
    assert np.array_equal(port.calculate_posteriors(counts, alphas, True, 0.1, device="cpu"),
                          whole)
    on_device = port.posteriors_on_device(counts, alphas, True, 0.1, device="cpu")
    assert isinstance(on_device, torch.Tensor) and np.array_equal(on_device.numpy(), whole)


@pytest.mark.parametrize("fn", ["find_dirichlet_priors", "calculate_posteriors"])
def test_cuda_without_card_raises(fn):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    args = (R_COUNTS,) if fn == "find_dirichlet_priors" else (R_COUNTS, [1.0, 0.5, 0.2], False, 0.1)
    with pytest.raises(DeviceUnavailableError):
        getattr(port, fn)(*args, device="cuda")


# -- on the card --

@pytest.mark.cuda
@pytest.mark.parametrize("method", ["FPI", "LOO"])
def test_model_on_the_card_matches_cpu(method):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counts = _pileup_counts(21, rows=200_000)
    kw = dict(method=method, error_filt_threshold=0.01)
    a_cpu, it_cpu = fit_with_iterations(counts, device="cpu", **kw)
    a_gpu, it_gpu = fit_with_iterations(counts, device="cuda", **kw)
    assert it_cpu == it_gpu
    np.testing.assert_allclose(a_gpu, a_cpu, rtol=RTOL)
    for keep in (False, True):
        want = port.calculate_posteriors(counts, a_cpu, keep, 0.125, device="cpu")
        got = port.calculate_posteriors(counts, a_cpu, keep, 0.125, device="cuda")
        assert np.array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=RTOL)
