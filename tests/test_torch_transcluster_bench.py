"""The port's transmission-model bench
(``tracs_tpu_torch.experiments.transcluster_bench``) on the CPU against the
JAX package's ``scripts/transcluster_bench.py``: ``load_mix`` gives the
script's arrays (the synthetic mix and a north-star CSV); on a 2,000-row cut
of the synthetic mix the lookups equal ``tracs_tpu``'s ``TransClusterCache``;
the JSON line carries the script's keys, in its order, then ``device``;
``--device cuda`` without a card exits 1.

Tolerance: p0 and E(K) at rtol 1e-9 on every row.  The reference's k-loop
exit, ``upper_bound - sum(bound terms) > precision``, subtracts two numbers
near the E(K) bound (~1e9 here); both float64 engines carry that sum's
terms through lgamma recurrences of thousands, so it is off by ~1e-12 of the
bound, and on a few rows the two stop one step apart.  On those rows the
shorter sum plus the one term it lacks, evaluated exactly (50-digit mpmath
of the reference's series), is held to the longer at rtol 1e-9; and, as the
witness that rounding decides their exit, the exact margin
``upper_bound - sum - precision`` where the shorter sum stopped lies within
2e-12 of the bound (the port's float64 sum is off by 0.2-1.4e-12 of it on
these rows)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tracs_tpu_torch.experiments import transcluster_bench as port_tcb
from tracs_tpu_torch.models.transcluster import TransClusterCache, _trans_dist_steps
from tracs_tpu_torch.runtime.device import DeviceUnavailableError

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 2000


@pytest.fixture(scope="module")
def ref_script():
    spec = importlib.util.spec_from_file_location(
        "transcluster_bench_reference", os.path.join(REPO, "scripts", "transcluster_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cut():
    snp, dd, _ = port_tcb.load_mix(None)
    return snp[:ROWS], dd[:ROWS]


def test_synthetic_mix_equals_the_script(ref_script):
    got, want = port_tcb.load_mix("no/such/file.csv"), ref_script.load_mix("no/such/file.csv")
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) == 250_000


def test_csv_mix_equals_the_script(ref_script, tmp_path):
    path = tmp_path / "dists.csv"
    rng = np.random.default_rng(5)
    with open(path, "w") as fh:
        fh.write("sampleA,sampleB,date difference,SNP distance,transmission distance,"
                 "expected K,filtered SNP distance,sites considered\n")
        for k in range(50):
            fh.write(f"s{k},s{k + 1},{rng.random() * 9:.6f},{rng.integers(0, 200)},"
                     f"0.5,1.25,0,999000\n")
    got, want = port_tcb.load_mix(str(path)), ref_script.load_mix(str(path))
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) == 50


def _exact_series(N: int, delta: float, lamb: float, beta: float):
    """(U, b, e) of one (N, delta) lane in 50-digit arithmetic: the E(K)
    bound U, and ``b(k)``, ``e(k)``, the k-th terms of the exit test's
    bound sum and of E(K) = sum k P(k) (the reference's second variant,
    src/transcluster.hpp:140-238)."""
    import mpmath as mp

    mp.mp.dps = 50
    lamb, beta, delta = mp.mpf(lamb), mp.mpf(beta), mp.mpf(delta)
    lb = lamb + beta
    pois = mp.log(mp.fsum(mp.exp(i * mp.log(lamb * delta) - mp.loggamma(i + 1))
                          for i in range(N + 1)))
    U = mp.exp(mp.log(beta) + delta * lamb + mp.log(N + 1) - mp.log(lamb) - pois)

    def lhs(k):
        return ((N + 1) * mp.log(lamb) + k * mp.log(beta) + mp.loggamma(N + k + 1)
                - mp.loggamma(N + 1) - mp.loggamma(k + 1) - delta * beta - pois)

    def b(k):
        return mp.exp(lhs(k) + mp.log(k) + delta * lb - (N + k + 1) * mp.log(lb))

    def e(k):
        M = N + k
        integral = mp.fsum(delta ** (M - i) / (mp.factorial(M - i) * lb ** (i + 1))
                           for i in range(M + 1))
        return mp.exp(lhs(k) + mp.log(integral) + mp.log(k))

    return U, b, e


def test_lookups_equal_the_reference(cut):
    from tracs_tpu.models.transcluster import TransClusterCache as JaxCache

    snp, dd = cut
    lamb, beta, precision = port_tcb.LAMB, port_tcb.BETA, port_tcb.PRECISION
    p0, eK = TransClusterCache(lamb, beta, precision, device="cpu").lookup(snp, dd)
    jp0, jeK = (np.asarray(x) for x in JaxCache(lamb, beta, precision).lookup(snp, dd))
    _, eK_steps, k_end = _trans_dist_steps(snp, dd, lamb, beta, precision, device="cpu")
    np.testing.assert_array_equal(eK, eK_steps)
    np.testing.assert_allclose(p0, jp0, rtol=1e-9)
    apart = ~np.isclose(eK, jeK, rtol=1e-9, atol=0)
    assert apart.sum() <= ROWS // 100
    np.testing.assert_allclose(eK[~apart], jeK[~apart], rtol=1e-9)
    for i in np.flatnonzero(apart):
        U, b, e = _exact_series(int(snp[i]), float(dd[i]), lamb, beta)
        port_short = jeK[i] > eK[i]
        # the last k each engine summed: the port's is k_end - 1
        short_last = int(k_end[i]) - (1 if port_short else 2)
        short, long_ = (eK[i], jeK[i]) if port_short else (jeK[i], eK[i])
        assert float(short + e(short_last + 1)) == pytest.approx(long_, rel=1e-9), i
        margin = U - sum(b(k) for k in range(1, short_last + 1)) - precision
        assert abs(margin) < 2e-12 * U, (i, float(margin), float(U))


def test_json_line_follows_the_script(ref_script, cut, monkeypatch, capsys):
    """The script's own line on the cut (its ``load_mix`` stood in for), then
    the port's: the same keys in the same order, then ``device``; the same
    row and unique counts."""
    snp, dd = cut
    monkeypatch.setattr(ref_script, "load_mix", lambda csv: (snp, dd, "cut"))
    monkeypatch.setattr(sys, "argv", ["transcluster_bench.py", "unused.csv", "1"])
    ref_script.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = port_tcb.bench(snp, dd, repeats=2, device="cpu")
    assert list(got) == list(want) + ["device"]
    assert got["rows"] == want["rows"] == ROWS and got["unique"] == want["unique"]
    assert got["device"] == "cpu" and len(got["cold_s"]) == 2
    assert got["cold_s_median"] == pytest.approx(float(np.median(got["cold_s"])))
    assert got["unique_per_s"] > 0 and got["rows_per_s_warm_memo"] > 0


def test_cli_prints_one_json_line(tmp_path, capsys):
    path = tmp_path / "dists.csv"
    path.write_text("a,b,date,snp\nx,y,0.5,3\nx,z,1.5,7\ny,z,0.5,3\n")
    port_tcb.main([str(path), "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["rows"] == 3 and line["unique"] == 2 and line["device"] == "cpu"


def test_cuda_without_a_card_raises_and_the_cli_exits_1():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(DeviceUnavailableError):
        port_tcb.bench(np.array([3]), np.array([0.5]), device="cuda")
    r = subprocess.run([sys.executable, "-m", "tracs_tpu_torch.experiments.transcluster_bench",
                        "no/such.csv", "1"], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and r.stdout == ""
    assert "torch.cuda.is_available() is False" in r.stderr


def test_import_leaves_jax_unloaded():
    code = ("import sys; import tracs_tpu_torch.experiments.transcluster_bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tracs_tpu', 'scripts')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
