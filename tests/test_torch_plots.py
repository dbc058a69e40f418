"""The port's ``plot`` stage against tracs_tpu's on the CPU: the scatter and
line CSVs and the scatter HTML are byte-equal to tracs_tpu's (which writes
them with pandas; the port has no pandas), the frequency matrices and the
scatter table equal tracs_tpu's, and every PNG exists and decodes.  The
cases are tests/test_stages.py::test_plot_heatmap and the five tests of
tests/test_plots_extra.py.  A subprocess with pandas and matplotlib blocked
shows that the CLI imports and ``cluster`` runs without them, and that
``plot`` then exits non-zero naming matplotlib."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.stages import combine as port_combine
from tracs_tpu_torch.stages import plots as port

jax = pytest.importorskip("jax")

from tracs_tpu.stages import combine as ref_combine  # noqa: E402
from tracs_tpu.stages import plots as ref  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = ("sampleA,sampleB,date difference,SNP distance,transmission distance,expected K,"
          "filtered SNP distance,sites considered,MSA file\n")


def write_pileup(path, bases, depth=10):
    with gzip.open(path, "wt") as fh:
        for pos0, b in enumerate(bases):
            fh.write(f"chr1\t{pos0+1}\t{b}\t.\t{b}\t2:{depth}:{depth}\n")
    return str(path)


def _png_decodes(path):
    from PIL import Image

    with Image.open(path) as img:
        img.load()
        return img.size[0] > 0 and img.size[1] > 0


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("extra", [[], ["--threshold", "4"], ["--column-name", "sites considered",
                                                               "--threshold", "8"]])
def test_plot_heatmap(tmp_path, extra):
    """test_stages.py::test_plot_heatmap through both CLIs (a PNG each)."""
    dist_file = tmp_path / "d.csv"
    dist_file.write_text(HEADER + "a,b,NA,1,NA,NA,0,8,ref\na,c,NA,5,NA,NA,0,8,ref\n"
                         "b,c,NA,4,NA,NA,0,8,ref\n")
    port.plot_heatmap(str(dist_file), str(tmp_path / "hm"))
    assert (tmp_path / "hm.png").stat().st_size > 0 and _png_decodes(tmp_path / "hm.png")
    port_cli.main(["plot", "-i", str(dist_file), "-p", str(tmp_path / "cli"), "--type",
                   "heatmap", *extra])
    assert _png_decodes(tmp_path / "cli.png")


def test_heatmap_matrix_and_order_match_reference(tmp_path, rng):
    """The symmetric matrix (direct entries win, mirrored fill, NaN where no
    pair) and its single-linkage order equal tracs_tpu's."""
    import pandas as pd

    names = [f"s{k}" for k in range(9)]
    with open(tmp_path / "d.csv", "w") as fh:
        fh.write(HEADER)
        for _ in range(25):
            i, j = rng.choice(9, size=2, replace=False)
            fh.write(f"{names[i]},{names[j]},NA,{rng.integers(0, 40)},NA,NA,0,8,ref\n")
    df = pd.read_csv(tmp_path / "d.csv")
    table = port._read_distance_csv(str(tmp_path / "d.csv"),
                                    ["sampleA", "sampleB", "SNP distance"])
    order_names = sorted(set(df["sampleA"]).union(df["sampleB"]))
    want = ref._symmetric_distance_matrix(df, order_names)
    got = port._symmetric_distance_matrix(table, order_names)
    np.testing.assert_array_equal(got, want)
    assert list(port._single_linkage_order(got)) == list(ref._single_linkage_order(want))


@pytest.mark.parametrize("min_freq", [0.01, 0.0])
def test_plot_scatter_and_line(tmp_path, rng, min_freq):
    """test_plots_extra.py::test_plot_scatter_and_line: CSVs and HTML byte
    for byte, PNGs decode."""
    import json

    L = 300
    a = rng.choice(list("ACGT"), size=L)
    b = a.copy()
    for x in (10, 50, 100):
        b[x] = {"A": "C", "C": "G", "G": "T", "T": "A"}[b[x]]
    pa = write_pileup(tmp_path / "a.txt.gz", a)
    pb = write_pileup(tmp_path / "b.txt.gz", b)
    for fn, kind in ((ref.plot_pairwise_scatter, "jax"), (port.plot_pairwise_scatter, "port")):
        fn(pa, pb, str(tmp_path / f"{kind}_scatter"), min_freq=min_freq)
    for ext in (".csv", ".html"):
        assert _same_bytes(tmp_path / f"port_scatter{ext}", tmp_path / f"jax_scatter{ext}"), ext
    assert _png_decodes(tmp_path / "port_scatter.png")
    html = (tmp_path / "port_scatter.html").read_text()
    assert "Plotly.newPlot" in html and "cdn.plot.ly" in html
    fig = json.loads(html.split("const fig = ", 1)[1].split(";\nPlotly", 1)[0])
    rows = (tmp_path / "port_scatter.csv").read_text().splitlines()[1:]
    assert sum(len(t["x"]) for t in fig["data"]) == len(rows)

    for fn, kind in ((ref.plot_pairwise_line, "jax"), (port.plot_pairwise_line, "port")):
        fn(pa, pb, str(tmp_path / f"{kind}_line"), min_freq=0.0)
    assert _same_bytes(tmp_path / "port_line.csv", tmp_path / "jax_line.csv")
    assert _png_decodes(tmp_path / "port_line.png")


def _mixed_pileup(path, rng, contigs, L, second_rate=0.3):
    """Pileups with mixed sites (two alleles, random strand depths),
    uncovered sites and several contigs."""
    with gzip.open(path, "wt") as fh:
        for contig in contigs:
            for pos0 in range(L):
                if rng.random() < 0.1:
                    continue
                a, b = rng.choice(list("ACGT"), size=2, replace=False)
                if rng.random() < second_rate:
                    fa, fb, ra, rb = rng.integers(1, 9, size=4)
                    fh.write(f"{contig}\t{pos0 + 1}\t{a}\t.\t{a},{b}\t2:{fa},{fb}:{ra},{rb}\n")
                else:
                    d = rng.integers(1, 12)
                    fh.write(f"{contig}\t{pos0 + 1}\t{a}\t.\t{a}\t2:{d}:{d}\n")
    return str(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_freq", [0.0, 0.05, 0.3])
def test_mixed_pileups_write_the_reference_bytes(tmp_path, seed, min_freq):
    """Several contigs, mixed and uncovered sites, three frequency bands: the
    scatter CSV and HTML and the line CSV (its singleton drop included) are
    tracs_tpu's bytes."""
    rng = np.random.default_rng(seed)
    pa = _mixed_pileup(tmp_path / "A.txt.gz", rng, ["c1", "c2"], 120)
    pb = _mixed_pileup(tmp_path / "B.txt.gz", rng, ["c2", "c1", "c3"], 100)
    for mod, kind in ((ref, "jax"), (port, "port")):
        mod.plot_pairwise_scatter(pa, pb, str(tmp_path / f"{kind}_s"), min_freq=min_freq)
        mod.plot_pairwise_line(pa, pb, str(tmp_path / f"{kind}_l"), min_freq=min_freq)
    for name in ("_s.csv", "_s.html", "_l.csv"):
        assert _same_bytes(tmp_path / f"port{name}", tmp_path / f"jax{name}"), name


def test_read_pileup_frequency_values(tmp_path):
    """test_plots_extra.py::test_read_pileup_frequency_values, and equal to
    tracs_tpu's matrices."""
    p = str(tmp_path / "p.txt.gz")
    with gzip.open(p, "wt") as fh:
        fh.write("c1\t1\tA\t.\tA,C\t2:4,1:2,1\n")
        fh.write("c1\t2\tG\t.\tG\t2:5:0\n")
        fh.write("c1\t3\tN\t.\tA\t2:3:3\n")
        fh.write("c2\t1\tT\t.\tT\t2:2:2\n")
    lengths = {"c1": 4, "c2": 2}
    f = port.read_pileup(p, lengths, require_both_strands=True)
    assert set(f) == {"c1", "c2"}
    want_c1 = np.zeros((4, 4))
    want_c1[0] = [6 / 8, 2 / 8, 0, 0]
    np.testing.assert_allclose(f["c1"], want_c1)
    np.testing.assert_allclose(f["c2"], [[0, 0, 0, 1.0], [0, 0, 0, 0]])
    f2 = port.read_pileup(p, lengths, require_both_strands=False)
    np.testing.assert_allclose(f2["c1"][1], [0, 0, 1.0, 0])
    f3 = port.read_pileup(p, lengths, keep_contigs=["c2"])
    assert set(f3) == {"c2"}
    for kw in ({}, {"require_both_strands": False}, {"keep_contigs": ["c2"]}):
        got, want = port.read_pileup(p, lengths, **kw), ref.read_pileup(p, lengths, **kw)
        assert list(got) == list(want)
        for c in want:
            assert np.array_equal(got[c], want[c])


def test_scatter_frame_values(tmp_path):
    """test_plots_extra.py::test_scatter_frame_values: the table's columns
    equal tracs_tpu's DataFrame column for column."""
    pa, pb = str(tmp_path / "A.txt.gz"), str(tmp_path / "B.txt.gz")
    with gzip.open(pa, "wt") as fh:
        fh.write("c1\t1\tA\t.\tA\t2:5:5\n")
        fh.write("c1\t2\tC\t.\tC\t2:5:5\n")
        fh.write("c1\t3\tA\t.\tA,C\t2:3,1:3,1\n")
    with gzip.open(pb, "wt") as fh:
        fh.write("c1\t1\tA\t.\tA\t2:4:4\n")
        fh.write("c1\t2\tG\t.\tG\t2:4:4\n")
        fh.write("c1\t3\tA\t.\tA\t2:4:4\n")
    lengths = {"c1": 3}
    fA, fB = port.read_pileup(pa, lengths), port.read_pileup(pb, lengths)
    got = port._pairwise_frame(pa, pb, fA, fB, min_freq=0.01)
    want = ref._pairwise_frame(pa, pb, fA, fB, min_freq=0.01)
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert got[col].tolist() == want[col].tolist(), col
    a = {(int(p), str(al)): k for k, (p, al, s) in
         enumerate(zip(got["position"], got["allele"], got["sample"])) if s == "A"}
    assert got["allmismatch"][a[2, "C"]] and not got["match"][a[2, "C"]]
    assert (1, "A") not in a
    assert got["frequency"][a[3, "A"]] == 0.75 and got["match"][a[3, "A"]]
    assert got["frequency"][a[3, "C"]] == 0.25 and not got["match"][a[3, "C"]]
    assert got["variable"][a[3, "C"]]
    assert (got["frequency"] >= 0.01).all()


def test_line_selects_consensus_diff_minor_alleles(tmp_path):
    """test_plots_extra.py::test_line_selects_consensus_diff_minor_alleles."""
    pa, pb = str(tmp_path / "A.txt.gz"), str(tmp_path / "B.txt.gz")
    with gzip.open(pa, "wt") as fh:
        fh.write("c1\t1\tA\t.\tA,C\t2:6,4:6,4\n")
        fh.write("c1\t2\tG\t.\tG\t2:5:5\n")
    with gzip.open(pb, "wt") as fh:
        fh.write("c1\t1\tC\t.\tA,C\t2:4,6:4,6\n")
        fh.write("c1\t2\tG\t.\tG\t2:5:5\n")
    for mod, kind in ((ref, "jax"), (port, "port")):
        mod.plot_pairwise_line(pa, pb, str(tmp_path / kind), min_freq=0.05)
    assert _same_bytes(tmp_path / "port.csv", tmp_path / "jax.csv")
    rows = [ln.split(",") for ln in (tmp_path / "port.csv").read_text().splitlines()]
    assert rows[0] == ["position", "allele", "frequency", "sample", "contig", "sample_code"]
    assert {r[0] for r in rows[1:]} == {"1"} and {r[1] for r in rows[1:]} == {"A", "C"}
    assert sorted(float(r[2]) for r in rows[1:] if r[3] == "A") == [0.4, 0.6]
    assert {r[5] for r in rows[1:] if r[3] == "A"} == {"1"}
    assert {r[5] for r in rows[1:] if r[3] == "B"} == {"0"}


def test_combine_pileup_coverage(tmp_path):
    """test_plots_extra.py::test_combine_pileup_coverage: the combine stage's
    --coverage helper, equal to tracs_tpu's."""
    d = tmp_path / "s1"
    d.mkdir()
    pile = write_pileup(d / "s1_ref_REFX_pileup.txt.gz", list("ACGT"), depth=5)
    covered, mean_depth, mean_nonzero = port_combine.pileup_coverage(pile)
    assert covered == 4 and mean_depth == 5.0 and mean_nonzero == 5.0
    assert port_combine.pileup_coverage(pile) == ref_combine.pileup_coverage(pile)


def test_cli_works_without_pandas_and_matplotlib(tmp_path):
    """With pandas and matplotlib blocked, the CLI imports, ``cluster`` runs,
    and ``plot`` exits non-zero with a message naming matplotlib."""
    dist = tmp_path / "d.csv"
    dist.write_text(HEADER + "a,b,NA,1,NA,NA,0,8,ref\nb,c,NA,50,NA,NA,0,8,ref\n")
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import tracs_tpu_torch.cli as cli\n"
        f"cli.main(['cluster', '-d', {str(dist)!r}, '-o', {str(tmp_path / 'c.csv')!r}, "
        "'-c', '10', '-D', 'snp'])\n"
        "print('cluster ran')\n"
        f"cli.main(['plot', '-i', {str(dist)!r}, '-p', {str(tmp_path / 'hm')!r}, "
        "'--type', 'heatmap'])\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert "cluster ran" in r.stdout, r.stderr
    assert (tmp_path / "c.csv").read_text().startswith("sample,cluster\n")
    assert r.returncode != 0
    assert "matplotlib" in r.stderr.splitlines()[-1]
    assert not (tmp_path / "hm.png").exists()
