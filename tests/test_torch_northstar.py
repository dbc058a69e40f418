"""The port's north-star entry point (``tracs_tpu_torch.experiments.northstar``)
at a tiny size on the CPU: ``prep`` writes byte for byte what the JAX
package's ``scripts/northstar.py prep`` writes; ``cli`` (with and without
``--filter``, through a pack cache) writes the CSV of tracs_tpu's
``distance --mesh off`` with the same flags, every column byte-equal except
transmission distance and expected K, which are held at rtol 1e-9 (two f64
engines); ``engines`` reports equal arrays from the split, popcount and mxu
engines."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from tracs_tpu_torch.experiments import northstar as port

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, L = 24, 5000


@pytest.fixture(scope="module")
def ref_script():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)  # the script imports bench.py from the repo root
    spec = importlib.util.spec_from_file_location(
        "northstar_reference", os.path.join(REPO, "scripts", "northstar.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, ref_script):
    """(port's prep dir, the JAX script's prep dir)."""
    jax_dir = str(tmp_path_factory.mktemp("ns_jax"))
    port_dir = str(tmp_path_factory.mktemp("ns_port"))
    ref_script.prep(jax_dir, N, L)
    port.main(["prep", port_dir, str(N), str(L)])
    return port_dir, jax_dir


def test_prep_is_byte_equal_to_the_script(dirs):
    port_dir, jax_dir = dirs
    for name in ("big.fasta", "dates.csv"):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(port_dir, "big.fasta")) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 2 * N and lines[0] == ">s0" and len(lines[1]) == L


def _rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split(",") for line in fh]


@pytest.mark.parametrize("filt", [False, True])
def test_cli_matches_tracs_tpu_distance(dirs, ref_script, tmp_path, capsys, filt):
    port_dir, jax_dir = dirs
    tag = "_filter" if filt else ""
    ref_script.cli(jax_dir, int(filt))
    capsys.readouterr()
    cache = str(tmp_path / "cache")
    recs = []
    for _ in range(2):  # cold, then warm from the cache
        port.main(["cli", port_dir, "--device", "cpu", "--pack-cache", cache]
                  + (["--filter"] if filt else []))
        recs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert [r["pack_cache"] for r in recs] == ["cold", "warm"]
    assert recs[0]["sha256"] == recs[1]["sha256"]
    got = _rows(os.path.join(port_dir, f"dists{tag}.csv"))
    want = _rows(os.path.join(jax_dir, f"dists{tag}.csv"))
    assert len(got) == len(want) == recs[0]["rows"] + 1
    cluster = max(6, round(0.005 * N) + 1)
    sizes = np.bincount(np.arange(N) // cluster)
    assert recs[0]["rows"] == int((sizes * (sizes - 1) // 2).sum())
    assert recs[0]["peak_device_bytes"] is None and recs[0]["device"] == "cpu"
    floats = {4, 5}  # transmission distance, expected K
    for g, w in zip(got, want):
        assert [x for k, x in enumerate(g) if k not in floats] == \
            [x for k, x in enumerate(w) if k not in floats]
    g = np.array([[float(r[k]) for k in sorted(floats)] for r in got[1:]])
    w = np.array([[float(r[k]) for k in sorted(floats)] for r in want[1:]])
    np.testing.assert_allclose(g, w, rtol=1e-9)


def test_engines_report_equal_arrays(dirs, capsys):
    port_dir, _ = dirs
    assert port.main(["engines", port_dir, "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["equal"] and rec["popcount_equals_split"] and rec["mxu_equals_split"]
    assert rec["blocks"] == 1 and rec["n"] == N and rec["pack_cache"] == "off"
    for method in ("split", "popcount", "mxu"):
        runs = rec[f"{method}_warm_runs_s"]
        assert len(runs) == 3 and rec[f"{method}_warm_s"] == sorted(runs)[1]
