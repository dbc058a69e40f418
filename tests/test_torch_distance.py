"""The port's ``distance`` stage against tracs_tpu's on the CPU, plus the
guards that keep the port free of jax and honest about its device.

Without --meta the CSV bytes are identical.  With --meta every column but
two is compared exactly (names, date difference, SNP distance, the NA
filtered column, sites considered, MSA file, and the set and order of the
rows); the transmission distance and expected K come from two float64
engines whose exp/log/lgamma differ by ulps, and are compared at rtol 1e-9."""

import gc
import gzip
import json
import os
import re
import subprocess
import sys
import weakref

import numpy as np
import pytest

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.stages import distance as port_distance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
PORT_DIR = os.path.join(REPO, "tracs_tpu_torch")


def _write_msa(path, rng, n, L, alphabet="ACGTMRWSYKVHDBN-acgt", prefix="s"):
    chars = np.array(list(alphabet))
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        for k in range(n):
            fh.write(f">{prefix}{k}\n{''.join(rng.choice(chars, size=L))}\n")
    return str(path)


def _clustered_msa(path, rng, n, L, prefix="c"):
    """Samples near a few random centres, so a small -D keeps some pairs."""
    centres = rng.choice(np.array(list("ACGT")), size=(3, L))
    with open(path, "w") as fh:
        for k in range(n):
            s = centres[k % 3].copy()
            hit = rng.choice(L, size=int(rng.integers(0, 12)), replace=False)
            s[hit] = rng.choice(np.array(list("ACGTNRY-")), size=len(hit))
            fh.write(f">{prefix}{k}\n{''.join(s)}\n")
    return str(path)


def _run_both(tmp_path, args):
    """CSV bytes of tracs_tpu and of the port for the same distance args."""
    pytest.importorskip("jax")
    from tracs_tpu import cli as jax_cli

    want = str(tmp_path / "jax.csv")
    got = str(tmp_path / "port.csv")
    jax_cli.main(["distance", *args, "-o", want, "--mesh", "off"])
    port_cli.main(["distance", *args, "-o", got, "--device", "cpu"])
    with open(want, "rb") as fh:
        want_b = fh.read()
    with open(got, "rb") as fh:
        got_b = fh.read()
    return got_b, want_b


def test_ambig_csv_matches_reference(tmp_path):
    got, want = _run_both(tmp_path, ["--msa", os.path.join(DATA, "ambig.aln")])
    assert got == want
    lines = got.decode().splitlines()
    assert len(lines) == 11
    row = lines[1].split(",")
    assert row[2] == row[4] == row[5] == "NA" and row[6] == "0"


@pytest.mark.parametrize("extra", [[], ["-D", "40"], ["--row-block", "3"], ["--row-block", "3", "-D", "40"]])
def test_random_msa_csv_matches_reference(tmp_path, extra):
    rng = np.random.default_rng(len(extra))
    msa = _clustered_msa(tmp_path / "rand.fasta", rng, 17, 301)
    got, want = _run_both(tmp_path, ["--msa", msa, *extra])
    assert got == want and got.count(b"\n") > 1


def test_gz_and_several_msas_match_reference(tmp_path):
    rng = np.random.default_rng(21)
    a = _write_msa(tmp_path / "one_combined.fasta.gz", rng, 9, 150)
    b = _write_msa(tmp_path / "two.aln", rng, 6, 77, prefix="t")
    got, want = _run_both(tmp_path, ["--msa", a, b, "-D", "120"])
    assert got == want
    assert b",one\n" in got and b",two\n" in got


@pytest.mark.parametrize("row_block", [None, "2"])
def test_msa_db_csv_matches_reference(tmp_path, row_block):
    rng = np.random.default_rng(22)
    q = _write_msa(tmp_path / "q.fasta", rng, 7, 200, prefix="q")
    db = _write_msa(tmp_path / "db.fasta", rng, 5, 200, prefix="d")
    args = ["--msa", q, "--msa-db", db, "-D", "190"]
    if row_block:
        args += ["--row-block", row_block]
    got, want = _run_both(tmp_path, args)
    assert got == want and got.count(b"\n") > 1


def test_resume_after_interruption_matches_reference(tmp_path):
    """A run cut after its first block (a partial line past the cursor's
    byte offset) resumes to the bytes of an uninterrupted run."""
    rng = np.random.default_rng(23)
    msa = _clustered_msa(tmp_path / "r.fasta", rng, 13, 256)
    args = ["--msa", msa, "-D", "60", "--row-block", "3"]
    full, want = _run_both(tmp_path, args)
    assert full == want

    out = str(tmp_path / "resumed.csv")
    keep = b"".join(
        line for line in full.splitlines(keepends=True)
        if line.startswith(b"sampleA") or int(line.split(b",")[0][1:]) < 3
    )
    with open(out, "wb") as fh:
        fh.write(keep + b"c4,c7,NA,9")  # a line cut mid-write
    with open(out + ".cursor", "w") as fh:
        json.dump({"msa_index": 0, "next_row": 3, "bytes": len(keep)}, fh)
    port_cli.main(["distance", *args, "-o", out, "--device", "cpu", "--resume"])
    with open(out, "rb") as fh:
        assert fh.read() == want
    assert not os.path.exists(out + ".cursor")


def test_large_input_streams_automatically(tmp_path, monkeypatch):
    """Above the sample-count bound the non-streaming call streams in row
    blocks; the count comes from the packed alignment and the CSV is the
    same."""
    rng = np.random.default_rng(24)
    msa = _clustered_msa(tmp_path / "big.fasta", rng, 11, 128)
    monkeypatch.setattr(port_distance, "_AUTO_STREAM_SAMPLES", 4)
    seen = []
    real = port_distance._distance_streaming
    monkeypatch.setattr(port_distance, "_distance_streaming",
                        lambda *a: seen.append(a[0].row_block) or real(*a))
    got, want = _run_both(tmp_path, ["--msa", msa, "-D", "30"])
    assert got == want and seen == [1024]


@pytest.mark.parametrize("order", ["large first", "small first", "large between"])
@pytest.mark.parametrize("meta", [False, True])
def test_one_msa_at_a_time_matches_reference(tmp_path, monkeypatch, order, meta):
    """Several MSAs of different sample counts, one above the streaming bound:
    each is packed once, when its turn comes, and only one is held; the
    large one and those after it stream, and the CSV is tracs_tpu's."""
    rng = np.random.default_rng(26)
    small = _clustered_msa(tmp_path / "small_combined.fasta", rng, 5, 128, prefix="a")
    large = _clustered_msa(tmp_path / "large.fasta", rng, 11, 160, prefix="b")
    other = _clustered_msa(tmp_path / "other.fasta", rng, 4, 96, prefix="d")
    msas = {"large first": [large, small], "small first": [small, large],
            "large between": [small, large, other]}[order]
    monkeypatch.setattr(port_distance, "_AUTO_STREAM_SAMPLES", 8)
    packs, refs, alive = [], [], []
    real_pack = port_distance.pack_fasta

    def counting_pack(path, **kwargs):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))  # earlier MSAs still held
        packs.append(os.path.basename(path))
        packed = real_pack(path, **kwargs)
        refs.append(weakref.ref(packed))
        return packed

    monkeypatch.setattr(port_distance, "pack_fasta", counting_pack)
    args = ["--msa", *msas, "-D", "60"]
    if meta:
        names = [f"{p}{k}" for p, n in (("a", 5), ("b", 11), ("d", 4)) for k in range(n)]
        args += ["--meta", _write_dates(tmp_path / "dates.csv", names, rng)]
    got, want = _run_both(tmp_path, args)
    if meta:
        _assert_meta_csv_close(got, want)
    else:
        assert got == want
    assert got.count(b"\n") > 3
    assert packs == [os.path.basename(m) for m in msas]  # each MSA packed once, in turn
    assert max(alive) <= 1  # the one being replaced, never the sum over the MSAs
    assert not os.path.exists(str(tmp_path / "port.csv") + ".cursor")


def test_python_writer_matches_native(tmp_path, monkeypatch):
    """Without the native library the Python CSV writer gives the same bytes."""
    import tracs_tpu_torch.stages.distance as d

    rng = np.random.default_rng(25)
    msa = _clustered_msa(tmp_path / "w.fasta", rng, 12, 99)
    native = str(tmp_path / "native.csv")
    port_cli.main(["distance", "--msa", msa, "-o", native, "--device", "cpu"])
    monkeypatch.setattr(d, "native_format_rows", lambda *a, **k: None)
    plain = str(tmp_path / "plain.csv")
    port_cli.main(["distance", "--msa", msa, "-o", plain, "--device", "cpu"])
    with open(native, "rb") as a, open(plain, "rb") as b:
        assert a.read() == b.read()


# -- --meta: the transmission model --

def _write_dates(path, names, rng, missing=()):
    """A --meta CSV: a date in 2019-2020 for each name, clustered so that
    some pairs are days apart and some months."""
    from datetime import date, timedelta

    base = rng.integers(0, 600, size=3)
    with open(path, "w") as fh:
        fh.write("name,date\n")
        for k, name in enumerate(names):
            if name in missing:
                continue
            day = date(2019, 1, 1) + timedelta(days=int(base[k % 3] + rng.integers(0, 181)))
            fh.write(f"{name},{day.isoformat()}\n")
    return str(path)


def _assert_meta_csv_close(got, want):
    """Same header and rows in the same order; every column exact but the
    transmission distance and expected K, which agree at rtol 1e-9."""
    got, want = got.decode().splitlines(), want.decode().splitlines()
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        g, w = g.split(","), w.split(",")
        assert [g[k] for k in (0, 1, 2, 3, 6, 7, 8)] == [w[k] for k in (0, 1, 2, 3, 6, 7, 8)]
        assert g[6] == "NA"
        np.testing.assert_allclose([float(g[4]), float(g[5])], [float(w[4]), float(w[5])],
                                   rtol=1e-9)


@pytest.mark.parametrize(
    "extra", [[], ["-K", "3"], ["--row-block", "2"], ["--row-block", "2", "-K", "3"]])
def test_meta_ambig_matches_reference(tmp_path, extra):
    """The reference's golden input (tests/test_stages.py) through both
    stages, streaming and not, with and without -K."""
    args = ["--msa", os.path.join(DATA, "ambig.aln"),
            "--meta", os.path.join(DATA, "dates_ambig.csv"), *extra]
    got, want = _run_both(tmp_path, args)
    _assert_meta_csv_close(got, want)
    rows = [ln.split(",") for ln in got.decode().splitlines()[1:]]
    assert len(rows) == (3 if "-K" in extra else 10)
    seq12 = rows[0]
    assert (seq12[0], seq12[1], seq12[3]) == ("seq1", "seq2", "0")
    assert abs(float(seq12[2]) - 0.002737907006988508) < 1e-6
    assert abs(float(seq12[4]) - 0.23794988406662973) < 1e-6
    assert abs(float(seq12[5]) - 2.6335200453700187) < 1e-6


@pytest.mark.parametrize("extra", [[], ["-K", "6"], ["--row-block", "7"],
                                   ["--row-block", "7", "-K", "6"]])
def test_meta_clustered_msa_matches_reference(tmp_path, extra):
    """A seeded clustered MSA with seeded dates, large enough to stream in
    several row blocks; -K keeps some rows and drops others."""
    rng = np.random.default_rng(31)
    msa = _clustered_msa(tmp_path / "m.fasta", rng, 30, 401)
    dates = _write_dates(tmp_path / "dates.csv", [f"c{k}" for k in range(30)], rng)
    got, want = _run_both(tmp_path, ["--msa", msa, "--meta", dates, "-D", "20", *extra])
    _assert_meta_csv_close(got, want)
    n_rows = got.count(b"\n") - 1
    if "-K" in extra:
        assert 0 < n_rows < 135  # 3 clusters of 10: 135 pairs within -D 20
    else:
        assert n_rows == 135


@pytest.mark.parametrize("row_block", [None, "3"])
def test_meta_msa_db_matches_reference(tmp_path, row_block):
    rng = np.random.default_rng(32)
    q = _write_msa(tmp_path / "q.fasta", rng, 7, 200, prefix="q")
    db = _write_msa(tmp_path / "db.fasta", rng, 5, 200, prefix="d")
    dates = _write_dates(tmp_path / "dates.csv", [f"q{k}" for k in range(7)]
                         + [f"d{k}" for k in range(5)], rng)
    args = ["--msa", q, "--msa-db", db, "-D", "190", "--meta", dates]
    if row_block:
        args += ["--row-block", row_block]
    got, want = _run_both(tmp_path, args)
    _assert_meta_csv_close(got, want)
    assert got.count(b"\n") > 1


def test_meta_resume_after_interruption_matches_reference(tmp_path):
    """A --meta run cut after its first block resumes to the bytes of the
    port's uninterrupted run, which matches tracs_tpu's."""
    rng = np.random.default_rng(33)
    msa = _clustered_msa(tmp_path / "r.fasta", rng, 13, 256)
    dates = _write_dates(tmp_path / "dates.csv", [f"c{k}" for k in range(13)], rng)
    args = ["--msa", msa, "-D", "60", "--row-block", "3", "--meta", dates, "-K", "9"]
    full, want = _run_both(tmp_path, args)
    _assert_meta_csv_close(full, want)

    out = str(tmp_path / "resumed.csv")
    keep = b"".join(
        line for line in full.splitlines(keepends=True)
        if line.startswith(b"sampleA") or int(line.split(b",")[0][1:]) < 3
    )
    with open(out, "wb") as fh:
        fh.write(keep + b"c4,c7,0.0027")  # a line cut mid-write
    with open(out + ".cursor", "w") as fh:
        json.dump({"msa_index": 0, "next_row": 3, "bytes": len(keep)}, fh)
    port_cli.main(["distance", *args, "-o", out, "--device", "cpu", "--resume"])
    with open(out, "rb") as fh:
        assert fh.read() == full
    assert not os.path.exists(out + ".cursor")


@pytest.mark.parametrize("row_block", [[], ["--row-block", "4"]])
def test_meta_python_writer_matches_native(tmp_path, monkeypatch, row_block):
    """Without the native library the Python writer gives the same bytes
    for the transmission columns (Python float repr)."""
    import tracs_tpu_torch.stages.distance as d

    rng = np.random.default_rng(34)
    msa = _clustered_msa(tmp_path / "w.fasta", rng, 12, 99)
    dates = _write_dates(tmp_path / "dates.csv", [f"c{k}" for k in range(12)], rng)
    args = ["distance", "--msa", msa, "--meta", dates, "--device", "cpu", *row_block]
    native = str(tmp_path / "native.csv")
    port_cli.main([*args, "-o", native])
    monkeypatch.setattr(d, "native_format_rows", lambda *a, **k: None)
    plain = str(tmp_path / "plain.csv")
    port_cli.main([*args, "-o", plain])
    with open(native, "rb") as a, open(plain, "rb") as b:
        text = a.read()
        assert text == b.read()
    assert text.count(b",NA,") == text.count(b"\n") - 1  # only the filtered column


@pytest.mark.parametrize("row_block", [[], ["--row-block", "2"]])
def test_meta_missing_date_raises(tmp_path, row_block):
    """A sample in an emitted pair without a date raises KeyError, as in
    the reference."""
    rng = np.random.default_rng(35)
    msa = _clustered_msa(tmp_path / "x.fasta", rng, 6, 64)
    dates = _write_dates(tmp_path / "dates.csv", [f"c{k}" for k in range(6)], rng,
                         missing=("c4",))
    with pytest.raises(KeyError):
        port_cli.main(["distance", "--msa", msa, "--meta", dates, "-o",
                       str(tmp_path / "x.csv"), "--device", "cpu", *row_block])


# -- guards --

def test_default_device_cuda_exits_nonzero_without_card(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["distance", "--msa", os.path.join(DATA, "ambig.aln"),
                       "-o", str(tmp_path / "x.csv")])
    assert exc.value.code not in (0, None)
    assert "CUDA" in str(exc.value.code) and "--device cpu" in str(exc.value.code)


@pytest.mark.parametrize("flags", [["--filter", "--mesh", "auto"], ["--mesh", "2x1"]])
def test_mesh_flags_in_a_world_of_one(tmp_path, flags):
    """In one process (no process group) ``--mesh auto`` is this process's
    card, and writes the bytes of ``--mesh off``; a ``DPxSP`` shape needs a
    world of dp * sp processes and says so, naming both numbers."""
    argv = ["distance", "--msa", os.path.join(DATA, "ambig.aln"), "--device", "cpu"]
    if "2x1" in flags:
        with pytest.raises(ValueError, match="mesh 2x1 needs 2 processes, the world has 1"):
            port_cli.main([*argv, "-o", str(tmp_path / "x.csv"), *flags])
        return
    port_cli.main([*argv, "-o", str(tmp_path / "auto.csv"), *flags])
    port_cli.main([*argv, "-o", str(tmp_path / "off.csv"), "--filter", "--mesh", "off"])
    assert (tmp_path / "auto.csv").read_bytes() == (tmp_path / "off.csv").read_bytes()
    assert len((tmp_path / "auto.csv").read_bytes().splitlines()) > 1


def test_mesh_off_is_accepted(tmp_path):
    out = str(tmp_path / "x.csv")
    port_cli.main(["distance", "--msa", os.path.join(DATA, "ambig.aln"), "-o", out,
                   "--device", "cpu", "--mesh", "off"])
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("sub", ["threshold", "build-db", "plot", "doctor"])
def test_other_subcommands_not_yet_ported(sub, capsys):
    """The last four subcommands are ported: each has its own parser (an
    unknown option is refused by it) and none answers "not yet ported"."""
    assert not hasattr(port_cli, "_NOT_YET_PORTED")
    assert list(port_cli.SUBCOMMANDS) == ["align", "combine", "distance", "threshold",
                                          "cluster", "build-db", "pipe", "plot", "doctor"]
    with pytest.raises(SystemExit) as exc:
        port_cli.main([sub, "--help"])
    assert exc.value.code == 0
    assert f"tracs-tpu-torch {sub}" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        port_cli.main([sub, "--no-such-option"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "error:" in err and "not yet ported" not in err


def test_cli_import_leaves_jax_unloaded():
    code = (
        "import sys; import tracs_tpu_torch.cli; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tracs_tpu' or m.startswith('tracs_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|tracs_tpu|pandas|joblib)(\.|\s|$)", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT_DIR):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 10
    for path in sources:
        with open(path) as fh:
            hits = pattern.findall(fh.read())
        assert not hits, f"{path} imports {hits}"


def test_port_sources_read_no_environment_variable():
    pattern = re.compile(r"os\.environ|os\.getenv|\bgetenv\(")
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT_DIR):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            hits = pattern.findall(fh.read())
        assert not hits, f"{path} reads the environment: {hits}"
