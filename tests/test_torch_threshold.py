"""The port's ``threshold`` stage against tracs_tpu's on the CPU: the same
close and distant CSVs through both ``estimate_thresholds`` (and both CLIs)
give byte-equal parameter CSVs; the fits themselves agree at rtol 1e-9.
The case is tests/test_stages.py::test_threshold_stage."""

import numpy as np
import pytest

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.stages import threshold as port

jax = pytest.importorskip("jax")

from tracs_tpu import cli as jax_cli  # noqa: E402
from tracs_tpu.stages import threshold as ref  # noqa: E402


def _write(path, vals):
    with open(path, "w") as fh:
        fh.write("pair,snp\n")
        for i, v in enumerate(vals):
            fh.write(f"p{i},{v}\n")
    return str(path)


@pytest.mark.parametrize("seed,lam,r,p", [(5, 3, 20, 0.3), (6, 1, 8, 0.1), (7, 6, 50, 0.5)])
def test_threshold_stage(tmp_path, seed, lam, r, p):
    """test_stages.py::test_threshold_stage (seed 5), and two more mixes."""
    rng = np.random.default_rng(seed)
    close = _write(tmp_path / "close.csv", rng.poisson(lam, size=300))
    far = _write(tmp_path / "far.csv", rng.negative_binomial(r, p, size=300))
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    t_ref = ref.estimate_thresholds(close, far, str(want), 1)
    t_port = port.estimate_thresholds(close, far, str(got), 1)
    assert t_port == t_ref
    assert got.read_bytes() == want.read_bytes()
    lines = got.read_text().strip().split("\n")
    assert lines[0] == "parameter,value"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["r", "p", "q", "lambda", "snp_threshold"]
    if seed == 5:
        assert 9 <= t_port <= 30  # poisson.ppf(0.95, ~3) * 3 lands near 18

    cli_want, cli_got = tmp_path / "jax_cli.csv", tmp_path / "port_cli.csv"
    argv = ["threshold", "--close", close, "--distant", far, "-o"]
    jax_cli.main(argv + [str(cli_want)])
    port_cli.main(argv + [str(cli_got)])
    assert cli_got.read_bytes() == cli_want.read_bytes() == want.read_bytes()


def test_fits_match_reference_on_a_seeded_sample():
    """The NB background fit and the Poisson/NB mixture fit at rtol 1e-9."""
    rng = np.random.default_rng(11)
    distant = rng.negative_binomial(15, 0.25, size=500).astype(float)
    close = np.concatenate([rng.poisson(2.5, size=400),
                            rng.negative_binomial(15, 0.25, size=100)]).astype(float)
    r, p = port.fit_background(distant)
    np.testing.assert_allclose([r, p], ref.fit_background(distant), rtol=1e-9)
    q, lam = port.fit_mixture(close, r, p)
    np.testing.assert_allclose([q, lam], ref.fit_mixture(close, r, p), rtol=1e-9)
    assert 0 < q < 1 and lam > 0
    fit = port.ThresholdFit(r, p, q, lam)
    assert fit.snp_threshold == ref.ThresholdFit(r, p, q, lam).snp_threshold


def test_out_of_domain_parameters_are_rejected():
    """The minimised negative log-likelihood is +inf outside the domain (the
    documented deviation), so Nelder-Mead never lands there."""
    r, p = port.fit_background(np.array([3.0, 5.0, 8.0, 13.0, 4.0, 6.0]))
    assert r > 0 and 0 < p < 1
