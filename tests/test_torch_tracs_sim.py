"""The port's simulation harness (``tracs_tpu_torch.experiments.tracs_sim``)
against the JAX package's ``scripts/tracs_sim.py`` on the CPU: at a fixed
seed and small genomes, every file each writes (the genome FASTAs, the
gzipped read files, ``_dist_props.csv``, ``input_data.tsv``) and what each
prints are byte-equal.  The gzip headers carry the write time, so the read
files are compared decompressed.  The built-in read simulator, and the
``art_illumina`` branch through a stand-in on PATH that writes fixed FASTQs."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from tracs_tpu_torch.experiments import tracs_sim as port_sim

jax = pytest.importorskip("jax")  # the script imports tracs_tpu, and so jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "tracs_sim.py")
#: a stand-in for art_illumina: two FASTQs named after its ``-o`` prefix
FAKE_ART = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
printf '@r/1\\nACGT\\n+\\nIIII\\n' > "${out}1.fq"
printf '@r/2\\nTTGA\\n+\\nIIII\\n' > "${out}2.fq"
"""


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Two FASTAs holding three random genomes."""
    d = tmp_path_factory.mktemp("genomes")
    rng = np.random.default_rng(21)
    paths = []
    for k, names in enumerate((["gA", "gB"], ["gC"])):
        path = d / f"ref{k}.fasta"
        with open(path, "w") as fh:
            for name in names:
                seq = "".join(rng.choice(list("ACGT"), size=int(rng.integers(1500, 2500))))
                fh.write(f">{name} genome {name}\n{seq[:1000]}\n{seq[1000:]}\n")
        paths.append(str(path))
    return paths


def _tree(root):
    """{relative path: bytes} of every file under ``root``, gzip members
    decompressed."""
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                data = fh.read()
            out[os.path.relpath(path, root)] = gzip.decompress(data) if f.endswith(".gz") else data
    return out


def _run_both(tmp_path, monkeypatch, capsys, args, env=None):
    """(the script's files and stdout, the port's), each run from a directory
    of its own with ``--outdir out``."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    argv = args + ["--outdir", "out"]
    r = subprocess.run([sys.executable, SCRIPT] + argv, cwd=ref_dir, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    monkeypatch.chdir(port_dir)
    if env is not None:
        monkeypatch.setenv("PATH", env["PATH"])
    port_sim.main(argv)
    return (_tree(ref_dir / "out"), r.stdout), (_tree(port_dir / "out"), capsys.readouterr().out)


@pytest.mark.parametrize("seed,samples,strains,dist,alpha", [
    (0, 4, 1, 10, 1.0), (3, 3, 2, 7, 0.5), (11, 5, 3, 25, 2.0)])
def test_builtin_simulator_is_byte_equal(genomes, tmp_path, monkeypatch, capsys, seed,
                                         samples, strains, dist, alpha):
    args = ["--genomes", *genomes, "--n-samples", str(samples), "--n-strains", str(strains),
            "--dist", str(dist), "--dirichlet-alpha", str(alpha), "--seed", str(seed),
            "--coverage", "6", "--read-length", "60", "--error-rate", "0.01",
            "--simulator", "builtin"]
    (want, want_out), (got, got_out) = _run_both(tmp_path, monkeypatch, capsys, args)
    assert sorted(got) == sorted(want)
    assert {"_dist_props.csv", "input_data.tsv"} <= set(got)
    assert sum(k.endswith(".fastq.gz") for k in got) == 2 * samples
    for name in want:
        assert got[name] == want[name], name
    assert got_out == want_out
    truth = got["_dist_props.csv"].decode().splitlines()
    assert truth[-1] == f"# true transmission pair: sample0,sample1,{dist}"


def test_art_branch_is_byte_equal(genomes, tmp_path, monkeypatch, capsys):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    art = bin_dir / "art_illumina"
    art.write_text(FAKE_ART)
    art.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    args = ["--genomes", *genomes, "--n-samples", "3", "--n-strains", "2", "--seed", "5"]
    (want, want_out), (got, got_out) = _run_both(tmp_path, monkeypatch, capsys, args, env)
    assert sorted(got) == sorted(want) and got_out == want_out
    for name in want:
        assert got[name] == want[name], name
    r1 = got[os.path.join("sample0", "sample0_R1.fastq.gz")]
    assert r1 == b"@r/1\nACGT\n+\nIIII\n" * 2  # two genomes, one append each
    assert not any(k.endswith(".fq") for k in got)


def test_generate_genome_pair_places_exactly_d_sites():
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGT"), size=500))
    a, b, d = port_sim.generate_genome_pair(seq, 40, np.random.default_rng(2))
    assert d == 40 and len(a) == len(b) == 500
    assert sum(x != y for x, y in zip(a, b)) == 40
    assert sum(x != y for x, y in zip(a, seq)) == 20


def test_import_leaves_jax_unloaded():
    code = ("import sys; import tracs_tpu_torch.experiments.tracs_sim; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tracs_tpu', 'scripts')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
