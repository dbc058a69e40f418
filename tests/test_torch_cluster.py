"""The port's ``cluster`` stage, ``compat`` shim, CLI dispatch and public API
against tracs_tpu's on the CPU.  ``cluster`` writes the same bytes as
tracs_tpu's for the same distance file (integers and names only: no
tolerance); ``compat`` returns the same lists (floats at rtol 1e-9)."""

import os

import numpy as np
import pytest

import tracs_tpu_torch
from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.stages import cluster as port_cluster

jax = pytest.importorskip("jax")

import tracs_tpu  # noqa: E402
from tracs_tpu import cli as jax_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
HEADER = ("sampleA,sampleB,date difference,SNP distance,transmission distance,expected K,"
          "filtered SNP distance,sites considered,MSA file\n")
METRICS = ["snp", "filter", "direct", "expectedK"]


def _both_clusters(tmp_path, dist_file, threshold, metric):
    """Bytes of transmission clusters from tracs_tpu and from the port."""
    want, got = str(tmp_path / f"jax_{metric}.csv"), str(tmp_path / f"port_{metric}.csv")
    common = ["cluster", "-d", str(dist_file), "-c", str(threshold), "-D", metric]
    jax_cli.main([*common, "-o", want])
    port_cli.main([*common, "-o", got])
    with open(want, "rb") as a, open(got, "rb") as b:
        return b.read(), a.read()


def _random_distance_csv(path, rng, n=40, rows=300):
    names = [f"s{k}" for k in rng.permutation(n)]
    with open(path, "w") as fh:
        fh.write(HEADER)
        for _ in range(rows):
            i, j = rng.choice(n, size=2, replace=False)
            fh.write(f"{names[i]},{names[j]},{rng.random():.6f},{rng.integers(0, 60)},"
                     f"{rng.random():.6g},{rng.random() * 12:.6g},{rng.integers(0, 60)},"
                     f"{rng.integers(900, 1000)},ref\n")
    return path


def test_cluster_stage(tmp_path):
    """tests/test_stages.py::test_cluster_stage through both packages."""
    dist_file = tmp_path / "d.csv"
    dist_file.write_text(HEADER + "a,b,NA,1,NA,NA,0,8,ref\nb,c,NA,50,NA,NA,0,8,ref\n"
                         "d,e,NA,2,NA,NA,0,8,ref\n")
    got, want = _both_clusters(tmp_path, dist_file, 10, "snp")
    assert got == want
    lines = got.decode().splitlines()
    assert lines[0] == "sample,cluster"
    labels = dict(line.split(",") for line in lines[1:])
    assert labels["a"] == labels["b"] != labels["c"]
    assert labels["d"] == labels["e"] != labels["a"]
    assert [line.split(",")[0] for line in lines[1:]] == ["a", "b", "c", "d", "e"]


@pytest.mark.parametrize("metric,linked", zip(METRICS, [False, True, True, True]))
def test_cluster_metric_columns(tmp_path, metric, linked):
    """tests/test_stages.py::test_cluster_metric_columns: each metric reads
    its own column; the header is skipped whatever it says."""
    dist_file = tmp_path / "d.csv"
    dist_file.write_text("h\na,b,0.1,99,0.9,0.5,1,8,ref\n")
    got, want = _both_clusters(tmp_path, dist_file, 2, metric)
    assert got == want
    labels = dict(line.split(",") for line in got.decode().splitlines()[1:])
    assert (labels["a"] == labels["b"]) == linked


@pytest.mark.parametrize("metric,threshold", [("snp", 10), ("filter", 3), ("direct", 0.2),
                                              ("expectedK", 1.5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_random_file_matches_reference(tmp_path, seed, metric, threshold):
    rng = np.random.default_rng(seed)
    dist_file = _random_distance_csv(tmp_path / "d.csv", rng)
    got, want = _both_clusters(tmp_path, dist_file, threshold, metric)
    assert got == want and got.count(b"\n") > 10


@pytest.mark.parametrize("metric", METRICS)
def test_cluster_on_the_ports_distance_output(tmp_path, metric):
    """distance -> cluster end to end: the port's own CSV (with --meta and
    --filter, so all four metric columns hold numbers) clusters to the bytes
    tracs_tpu gives for the same file."""
    dist_file = str(tmp_path / "dist.csv")
    port_cli.main(["distance", "--msa", os.path.join(DATA, "ambig.aln"), "--meta",
                   os.path.join(DATA, "dates_ambig.csv"), "--filter", "-o", dist_file,
                   "--device", "cpu"])
    got, want = _both_clusters(tmp_path, dist_file, 2, metric)
    assert got == want and got.count(b"\n") == 6


@pytest.mark.parametrize("metric", METRICS)
def test_csv_module_reader_matches_native(tmp_path, monkeypatch, metric):
    """Without the native library the csv-module reader gives the same
    edges, names and clusters."""
    rng = np.random.default_rng(4)
    dist_file = _random_distance_csv(tmp_path / "d.csv", rng)
    col = port_cluster._METRIC_COLUMNS[metric]
    native = port_cluster.native_read_dist_csv(str(dist_file), col, 5.0)
    plain = port_cluster.read_dist_csv(str(dist_file), col, 5.0)
    assert native is not None
    assert np.array_equal(native[0], plain[0]) and np.array_equal(native[1], plain[1])
    assert native[2] == plain[2] and native[3] == plain[3] == 300
    out_native, out_plain = str(tmp_path / "n.csv"), str(tmp_path / "p.csv")
    port_cli.main(["cluster", "-d", str(dist_file), "-c", "5", "-D", metric, "-o", out_native])
    monkeypatch.setattr(port_cluster, "native_read_dist_csv", lambda *a: None)
    port_cli.main(["cluster", "-d", str(dist_file), "-c", "5", "-D", metric, "-o", out_plain])
    with open(out_native, "rb") as a, open(out_plain, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("row,message", [("a,b,NA,1,NA,NA,0,8,ref", "float"),
                                         ("a,b,NA", "too few columns")])
def test_cluster_rejects_bad_rows(tmp_path, monkeypatch, native, row, message):
    """A literal NA in the metric column raises, as ``float()`` would; so
    does a row without that column.  tracs_tpu raises the same error."""
    dist_file = tmp_path / "d.csv"
    dist_file.write_text(HEADER + row + "\n")
    if not native:
        monkeypatch.setattr(port_cluster, "native_read_dist_csv", lambda *a: None)
    argv = ["cluster", "-d", str(dist_file), "-c", "5", "-D", "direct", "-o",
            str(tmp_path / "c.csv")]
    with pytest.raises(ValueError, match=message):
        port_cli.main(argv)
    with pytest.raises(ValueError, match=message):
        jax_cli.main(argv)


@pytest.mark.parametrize("native", [True, False])
def test_cluster_without_rows_writes_nothing(tmp_path, monkeypatch, native, caplog):
    dist_file = tmp_path / "d.csv"
    dist_file.write_text(HEADER)
    if not native:
        monkeypatch.setattr(port_cluster, "native_read_dist_csv", lambda *a: None)
    out = tmp_path / "c.csv"
    port_cli.main(["cluster", "-d", str(dist_file), "-c", "5", "-D", "snp", "-o", str(out)])
    assert not out.exists()


def test_compat_module():
    """tests/test_streaming.py::test_compat_module through both shims."""
    from scipy.special import gammaln

    import tracs_tpu.compat as JTRACS
    import tracs_tpu_torch.compat as TRACS

    kw = dict(fasta=[os.path.join(DATA, "ambig.aln")], n_threads=1, dist=10, filter=False)
    got, want = TRACS.pairsnp(**kw, device="cpu"), JTRACS.pairsnp(**kw)
    assert got[0] == [0, 0, 0, 0, 1, 1, 1, 2, 2, 3]
    assert all(list(g) == list(w) for g, w in zip(got, want))
    lg = gammaln(range(20))
    lp = TRACS.lprob_k_given_N(7, 4, 0.16963, 3, 52, lg)
    assert abs(lp[0] + 17.9565184209608) < 1e-6
    np.testing.assert_allclose(lp, JTRACS.lprob_k_given_N(7, 4, 0.16963, 3, 52, lg), rtol=1e-9)
    args = ([0, 2], [0.002737907006988508] * 2, 29.903, 73.0, 0.01)
    p0, eK = TRACS.trans_dist(*args, device="cpu")
    assert isinstance(p0, list) and isinstance(eK, list)
    assert abs(np.exp(p0[0]) - 0.23794988406662973) < 1e-6
    jp0, jeK = JTRACS.trans_dist(*args)
    np.testing.assert_allclose(p0, jp0, rtol=1e-9)
    np.testing.assert_allclose(eK, jeK, rtol=1e-9)
    counts = np.arange(8.0).reshape(2, 4)
    post = TRACS.calculate_posteriors(counts, [1.0, 0.5, 0.2, 0.1], False, 0.0, device="cpu")
    assert post.shape == (2, 4)
    np.testing.assert_allclose(
        post, JTRACS.calculate_posteriors(counts, [1.0, 0.5, 0.2, 0.1], False, 0.0), rtol=1e-9)


def test_cli_dispatch(tmp_path):
    """tests/test_stages.py::test_cli_dispatch."""
    out = str(tmp_path / "d.csv")
    port_cli.main(["distance", "--msa", os.path.join(DATA, "ambig.aln"), "-o", out,
                   "--device", "cpu"])
    assert os.path.exists(out)
    with pytest.raises(SystemExit):
        port_cli.main(["--version"])


@pytest.mark.parametrize("stage", ["align", "combine", "distance", "cluster", "pipe"])
def test_stage_runners_take_argv(stage):
    """Every ported stage has a ``main(argv)`` as tracs_tpu's per-stage
    runners have, and its parser knows what tracs_tpu's knows."""
    import argparse
    import importlib

    port_mod = importlib.import_module(f"tracs_tpu_torch.stages.{stage}")
    jax_mod = importlib.import_module(f"tracs_tpu.stages.{stage}")
    with pytest.raises(SystemExit) as exc:
        port_mod.main(["--help"])
    assert exc.value.code == 0

    def options(mod):
        parser = getattr(mod, f"{stage}_parser")(argparse.ArgumentParser())
        return {s for a in parser._actions for s in a.option_strings}

    missing = options(jax_mod) - options(port_mod)
    assert not missing, missing
    if stage != "cluster" and stage != "combine":
        assert "--device" in options(port_mod)


def test_public_api_covers_the_reference():
    """``tracs_tpu_torch.__all__`` holds every public name of tracs_tpu; the
    modules still to port export nothing there, so nothing may be missing."""
    missing = sorted(set(tracs_tpu.__all__) - set(tracs_tpu_torch.__all__))
    assert missing == [], f"still missing from the port's public API: {missing}"
    for name in tracs_tpu_torch.__all__:
        assert hasattr(tracs_tpu_torch, name), name
    assert tracs_tpu_torch.iupac_code_for_mask(5) == tracs_tpu.iupac_code_for_mask(5) == "R"
