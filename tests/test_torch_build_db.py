"""The port's ``build-db`` stage against tracs_tpu's on the CPU, with no
sourmash (neither this machine nor the card's has it): the same genomes
through both CLIs give zips whose genome members and ``summary.tsv`` are
byte-equal and whose native sketches hold equal arrays (the zip headers and
the sketch member's own inner zip carry times, so the files themselves are
not compared).  Then ``align --device cpu`` on the port's database selects
the reference with the real native gather, with only the aligner stood in
for, and writes what tracs_tpu's ``align`` writes on tracs_tpu's database.
The cases are tests/test_sketch.py::test_build_db_and_align_native_gather
and tests/test_align_pipe.py::test_build_db_to_align_native_sketch_e2e."""

import gzip
import os
import zipfile

import numpy as np
import pytest

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch import sketch as port_sketch
from tracs_tpu_torch.stages import align as port_align
from tracs_tpu_torch.stages import build_db as port_build_db

jax = pytest.importorskip("jax")

from tracs_tpu import cli as jax_cli  # noqa: E402
from tracs_tpu import sketch as jax_sketch  # noqa: E402
from tracs_tpu.io.fasta import read_fasta  # noqa: E402
from tracs_tpu.stages import align as jax_align  # noqa: E402

MUT = {"A": "G", "C": "T", "G": "A", "T": "C"}


def _genomes(rng, names, L):
    return {name: "".join(rng.choice(list("ACGT"), size=L)) for name in names}


def _write_fastas(tmp_path, genomes, gz=()):
    paths = []
    for name, seq in genomes.items():
        text = f">chr1\n{seq}\n".encode()
        if name in gz:
            path = tmp_path / f"{name}.fasta.gz"
            path.write_bytes(gzip.compress(text, mtime=0))
        else:
            path = tmp_path / f"{name}.fasta"
            path.write_bytes(text)
        paths.append(str(path))
    return paths


def _build_both(tmp_path, argv_tail, monkeypatch):
    """(port zip, tracs_tpu zip) from ``build-db <argv_tail> -o <db>``, with
    sourmash absent for both whatever the machine has."""
    monkeypatch.setattr("shutil.which", lambda name: None)
    port_db, jax_db = tmp_path / "port_db", tmp_path / "jax_db"
    jax_cli.main(["build-db", *argv_tail, "-o", str(jax_db)])
    port_cli.main(["build-db", *argv_tail, "-o", str(port_db)])
    monkeypatch.undo()
    return str(port_db) + ".zip", str(jax_db) + ".zip"


def _assert_same_databases(port_zip, jax_zip):
    with zipfile.ZipFile(port_zip) as zp, zipfile.ZipFile(jax_zip) as zj:
        names = zp.namelist()
        assert names == zj.namelist()
        assert "sourmashDB.sbt.zip" not in names
        for name in names:
            if name != port_sketch.SKETCH_MEMBER:
                assert zp.read(name) == zj.read(name), name
    got, want = port_sketch.load_db_sketches(port_zip), jax_sketch.load_db_sketches(jax_zip)
    assert got[1:] == want[1:]
    assert list(got[0]) == list(want[0])
    for name in want[0]:
        assert np.array_equal(got[0][name], want[0][name]), name
    return names


def test_build_db_and_align_native_gather(tmp_path, monkeypatch):
    """test_sketch.py::test_build_db_and_align_native_gather: three 100 kb
    genomes, scale 50; reads tiling G1 select G1 alone."""
    rng = np.random.default_rng(84)
    genomes = _genomes(rng, ["G0", "G1", "G2"], 100_000)
    paths = _write_fastas(tmp_path, genomes, gz=("G2",))
    port_zip, jax_zip = _build_both(tmp_path, ["-i", *paths, "--scale", "50"], monkeypatch)
    names = _assert_same_databases(port_zip, jax_zip)
    # a gzipped input's prefix keeps ".fasta" (the name up to its last dot), in both
    assert names[:4] == ["G0.fasta.gz", "G1.fasta.gz", "G2.fasta.fasta.gz", "summary.tsv"]
    with zipfile.ZipFile(port_zip) as z:
        assert z.read("summary.tsv") == (b"G0,G0.fasta.gz\nG1,G1.fasta.gz\n"
                                         b"G2.fasta,G2.fasta.fasta.gz\n")
        assert gzip.decompress(z.read("G1.fasta.gz")).decode() == f">chr1\n{genomes['G1']}\n"
    loaded = port_sketch.load_db_sketches(port_zip)
    assert set(loaded[0]) == {"G0", "G1", "G2.fasta"} and loaded[1:] == (51, 50)

    reads = tmp_path / "q.fastq.gz"
    with gzip.open(reads, "wt") as fh:
        g = genomes["G1"]
        for i in range(0, len(g) - 300, 150):
            fh.write(f"@r{i}\n{g[i:i + 300]}\n+\n{'I' * 300}\n")

    def fake(reference, outdir, prefix, r1, r2=None, **kw):
        seq = genomes[prefix.split("_ref_")[-1]]
        with gzip.open(prefix + "_pileup.txt.gz", "wt") as fh:
            for pos0, b in enumerate(seq):
                fh.write(f"chr1\t{pos0 + 1}\t{b}\t.\t{b}\t2:10:10\n")

    for mod in (port_align, jax_align):
        monkeypatch.setattr(mod, "align_and_pileup", fake)
    port_out, jax_out = tmp_path / "port_out", tmp_path / "jax_out"
    jax_cli.main(["align", "-i", str(reads), "--database", jax_zip, "-o", str(jax_out),
                  "-p", "q"])
    port_cli.main(["align", "-i", str(reads), "--database", port_zip, "-o", str(port_out),
                   "-p", "q", "--device", "cpu"])
    produced = sorted(p.name for p in port_out.glob("*posterior_counts*fasta"))
    assert produced == ["q_posterior_counts_ref_G1.fasta"]
    for name in ("q_sourmash_hits.csv", "q_posterior_counts_ref_G1.fasta"):
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes(), name


def test_build_db_to_align_native_sketch_e2e(tmp_path, monkeypatch):
    """test_align_pipe.py::test_build_db_to_align_native_sketch_e2e: two
    60 kb genomes, scale 100; a sample three SNPs off GENOME2 is called on
    GENOME2 alone, the SNPs included."""
    rng = np.random.default_rng(231)
    L = 60_000
    genomes = _genomes(rng, ["GENOME1", "GENOME2"], L)
    paths = _write_fastas(tmp_path, genomes)
    port_zip, jax_zip = _build_both(tmp_path, ["-i", *paths, "--scale", "100"], monkeypatch)
    _assert_same_databases(port_zip, jax_zip)

    g2 = genomes["GENOME2"]
    sample = list(g2)
    for p in (77, 1234, 40_000):
        sample[p] = MUT[sample[p]]
    sample = "".join(sample)
    reads = tmp_path / "s1.fastq.gz"
    with gzip.open(reads, "wt") as fh:
        fh.write(f"@r1\n{sample}\n+\n{'F' * L}\n")

    def fake(reference, outdir, prefix, r1, r2=None, **kw):
        with gzip.open(prefix + "_pileup.txt.gz", "wt") as fh:
            for pos0, (rb, sb) in enumerate(zip(g2, sample)):
                fh.write(f"chr1\t{pos0 + 1}\t{rb}\t.\t{sb}\t2:10:10\n")

    for mod in (port_align, jax_align):
        monkeypatch.setattr(mod, "align_and_pileup", fake)
    port_out, jax_out = tmp_path / "port_out", tmp_path / "jax_out"
    argv = ["align", "-i", str(reads), "-p", "s1", "--min-cov", "2", "--database"]
    jax_cli.main(argv + [jax_zip, "-o", str(jax_out)])
    port_cli.main(argv + [port_zip, "-o", str(port_out), "--device", "cpu"])
    hits = (port_out / "s1_sourmash_hits.csv").read_text().splitlines()
    assert any("GENOME2" in line for line in hits[1:])
    assert not (port_out / "s1_posterior_counts_ref_GENOME1.fasta").exists()
    for name in ("s1_sourmash_hits.csv", "s1_posterior_counts_ref_GENOME2.fasta"):
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes(), name
    called = list(read_fasta(port_out / "s1_posterior_counts_ref_GENOME2.fasta"))[0][1]
    assert called == sample


def test_list_file_manifest_and_genome_member_bytes(tmp_path, monkeypatch):
    """A ``prefix,path`` list file as the one input; a plain FASTA's member is
    gzipped with mtime 0, so its bytes depend on the genome alone."""
    rng = np.random.default_rng(3)
    genomes = _genomes(rng, ["A1", "B2"], 2000)
    paths = _write_fastas(tmp_path, genomes)
    listing = tmp_path / "genomes.csv"
    listing.write_text("".join(f"ref{k},{p}\n" for k, p in enumerate(paths)))
    assert port_build_db._genome_manifest([listing]) == [
        (type(listing)(p), f"ref{k}") for k, p in enumerate(paths)]
    port_zip, jax_zip = _build_both(tmp_path, ["-i", str(listing), "--scale", "10"], monkeypatch)
    assert _assert_same_databases(port_zip, jax_zip)[:2] == ["ref0.fasta.gz", "ref1.fasta.gz"]
    with zipfile.ZipFile(port_zip) as z:
        member = z.read("ref1.fasta.gz")
    assert member[4:8] == b"\0\0\0\0"  # the gzip header's mtime
    os.utime(paths[1], (1, 1))
    assert gzip.decompress(member) == open(paths[1], "rb").read()


def test_no_input_genome_exits(tmp_path):
    empty = tmp_path / "genomes.csv"
    empty.write_text("\n")
    with pytest.raises(SystemExit, match="no input genomes"):
        port_cli.main(["build-db", "-i", str(empty), "-o", str(tmp_path / "db")])
