"""The port's host modules of the align path against tracs_tpu's on the CPU:
``sketch`` (FracMinHash sketches, gather, database zips), ``io/external``
(the command table and the aligner orchestration), ``io/pileup`` and the
``combine`` stage.  Everything here is integers, names and text: the two
packages must agree exactly, byte for byte where a file is written."""

import gzip
import os
import random

import numpy as np
import pytest

from tracs_tpu_torch import sketch as port_sk
from tracs_tpu_torch.io import external as port_ext
from tracs_tpu_torch.io import pileup as port_pileup
from tracs_tpu_torch.stages import combine as port_combine

jax = pytest.importorskip("jax")

from tracs_tpu import sketch as jax_sk  # noqa: E402
from tracs_tpu.io import external as jax_ext  # noqa: E402
from tracs_tpu.io import pileup as jax_pileup  # noqa: E402
from tracs_tpu.io.fasta import write_fasta  # noqa: E402
from tracs_tpu.stages import combine as jax_combine  # noqa: E402

_RC = str.maketrans("ACGT", "TGCA")


def make_genome(rng, L):
    return "".join(rng.choice(list("ACGT"), size=L))


def py_sketch(mod, seq, k, scaled):
    out = set()
    mod._sketch_seq_py(seq, k, mod._MASK64 // scaled, out)
    return np.array(sorted(out), dtype=np.uint64)


# -- sketch --

@pytest.mark.parametrize("case", ["plain", "reverse complement", "with N", "lower case"])
def test_python_sketch_matches_reference(case):
    """The cases of tests/test_sketch.py::test_canonical_hashing and
    test_invalid_bases_reset_window, and the same hashes from both packages."""
    rng = np.random.default_rng(1)
    seq = make_genome(rng, 3000)
    variant = {"plain": seq, "reverse complement": seq.translate(_RC)[::-1],
               "with N": seq[:1500] + "N" + seq[1500:], "lower case": seq.lower()}[case]
    got = py_sketch(port_sk, variant, 21, 20)
    assert np.array_equal(got, py_sketch(jax_sk, variant, 21, 20)) and len(got) > 10
    base = py_sketch(port_sk, seq, 21, 20)
    if case == "with N":  # all k-mers that do not span the N are shared
        assert len(np.intersect1d(got, base)) > 0.8 * len(base)
    else:
        assert np.array_equal(got, base)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["fasta.gz", "fastq.gz", "fasta"])
def test_sketch_file_matches_reference(tmp_path, monkeypatch, kind, native):
    """tests/test_sketch.py::test_native_matches_python and test_native_fastq:
    the native sketcher, and the Python route when the library is absent."""
    rng = np.random.default_rng(2)
    seq = make_genome(rng, 5000)
    path = tmp_path / f"g.{kind}"
    if kind.startswith("fastq"):
        with gzip.open(path, "wt") as fh:
            fh.write(f"@r1\n{seq}\n+\n{'I' * len(seq)}\n@r2 desc\n{seq[:200]}\n+\n{'I' * 200}\n")
    else:
        write_fasta(path, [("g", seq)])
    want = jax_sk.sketch_file(path, ksize=31, scaled=10)
    if not native:
        import tracs_tpu_torch.runtime.native as port_native

        monkeypatch.setattr(port_native, "get_lib", lambda: None)
    got = port_sk.sketch_file(path, ksize=31, scaled=10)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert np.array_equal(got, py_sketch(port_sk, seq, 31, 10))


def _refs_and_query(rng, k=21, scaled=10):
    genomes = {f"g{i}": make_genome(rng, 4000) for i in range(4)}
    refs = {n: py_sketch(port_sk, s, k, scaled) for n, s in genomes.items()}
    query = np.union1d(refs["g1"], refs["g3"])
    return refs, query


def test_gather_selects_constituents_like_reference():
    """tests/test_sketch.py::test_gather_selects_constituents."""
    refs, query = _refs_and_query(np.random.default_rng(3))
    got = port_sk.gather(query, refs, scaled=10, threshold_bp=500)
    want = jax_sk.gather(query, refs, scaled=10, threshold_bp=500)
    assert {h.name for h in got} == {"g1", "g3"} and all(h.f_match > 0.9 for h in got)
    assert [vars(h) for h in got] == [vars(h) for h in want]
    assert port_sk.gather(np.zeros(0, dtype=np.uint64), refs) == []


def test_hits_csv_bytes_match_reference(tmp_path):
    refs, query = _refs_and_query(np.random.default_rng(4))
    port_sk.write_hits_csv(port_sk.gather(query, refs, scaled=10, threshold_bp=500),
                           str(tmp_path / "p.csv"))
    jax_sk.write_hits_csv(jax_sk.gather(query, refs, scaled=10, threshold_bp=500),
                          str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_db_sketches_cross_the_packages(tmp_path, writer):
    """A database zip written by one package loads in the other: the same
    member name, metadata and hashes."""
    rng = np.random.default_rng(5)
    inputs = []
    for name in ("GA", "GB"):
        write_fasta(tmp_path / f"{name}.fasta", [("chr1", make_genome(rng, 20_000))])
        inputs.append((str(tmp_path / f"{name}.fasta"), name))
    zippath = str(tmp_path / "db.zip")
    (port_sk if writer == "port" else jax_sk).write_db_sketches(zippath, inputs, ksize=31,
                                                                scaled=50)
    got, want = port_sk.load_db_sketches(zippath), jax_sk.load_db_sketches(zippath)
    assert got[1:] == want[1:] == (31, 50) and set(got[0]) == {"GA", "GB"}
    for name in got[0]:
        assert np.array_equal(got[0][name], want[0][name]) and len(got[0][name]) > 100
    assert port_sk.SKETCH_MEMBER == jax_sk.SKETCH_MEMBER


def test_load_db_sketches_absent_member(tmp_path):
    import zipfile

    with zipfile.ZipFile(tmp_path / "db.zip", "w") as z:
        z.writestr("sourmashDB.sbt.zip", b"dummy")
    assert port_sk.load_db_sketches(str(tmp_path / "db.zip")) is None
    with pytest.raises(ValueError, match="native_sketches"):
        port_sk.native_gather([], str(tmp_path / "db.zip"), str(tmp_path / "h.csv"))


def test_native_gather_matches_reference(tmp_path):
    """Reads tiling one of three genomes select that genome alone, with the
    same hit CSV from both packages (the gather half of
    tests/test_sketch.py::test_build_db_and_align_native_gather)."""
    rng = np.random.default_rng(6)
    genomes = {f"G{i}": make_genome(rng, 100_000) for i in range(3)}
    inputs = []
    for name, seq in genomes.items():
        write_fasta(tmp_path / f"{name}.fasta", [("chr1", seq)])
        inputs.append((str(tmp_path / f"{name}.fasta"), name))
    zippath = str(tmp_path / "db.zip")
    port_sk.write_db_sketches(zippath, inputs, scaled=50)
    reads = tmp_path / "q.fastq.gz"
    with gzip.open(reads, "wt") as fh:
        g = genomes["G1"]
        for i in range(0, len(g) - 300, 150):
            fh.write(f"@r{i}\n{g[i:i + 300]}\n+\n{'I' * 300}\n")
    got = port_sk.native_gather([str(reads)], zippath, str(tmp_path / "p.csv"))
    want = jax_sk.native_gather([str(reads)], zippath, str(tmp_path / "j.csv"))
    assert got == want == ["G1"]
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


# -- the command table --

@pytest.mark.parametrize("name", sorted(jax_ext.COMMANDS))
def test_command_table_matches_reference(name):
    """Every entry of the contract table, field for field."""
    assert sorted(port_ext.COMMANDS) == sorted(jax_ext.COMMANDS)
    got, want = port_ext.COMMANDS[name], jax_ext.COMMANDS[name]
    assert (got.binaries, got.template, got.output_field, got.about) == (
        want.binaries, want.template, want.output_field, want.about)
    for binary in got.binaries:
        assert binary in port_ext.VERSION_PROBES
    if got.output_field is not None:
        assert "{" + got.output_field + "}" in got.template


def test_version_probes_match_reference():
    assert port_ext.VERSION_PROBES == jax_ext.VERSION_PROBES


GOLDEN_COMMANDS = [
    ("sourmash_sketch", dict(prefix="query", scaled=10000, ksize=51, output="/tmp/t/query.sig",
                             inputs="a.fastq.gz b.fastq.gz"),
     "sourmash sketch dna --merge query -p scaled=10000,k=51,noabund"
     " -o /tmp/t/query.sig a.fastq.gz b.fastq.gz"),
    ("sourmash_gather", dict(output="out/s1_sourmash_hits.csv", threshold_bp=50000,
                             query_sig="/tmp/t/query.sig", database="db/sourmashDB.sbt.zip"),
     "sourmash gather -o out/s1_sourmash_hits.csv --threshold-bp 50000"
     " --ignore-abundance /tmp/t/query.sig db/sourmashDB.sbt.zip"),
    ("map_filter_sort", dict(n_cpu=3, mode="-ax sr", reference="ref.fasta",
                             reads="r1.fq.gz r2.fq.gz", max_div=0.2, bam="/tmp/t/tmpbam"),
     "minimap2 -t 3 -p 1 -N 10 -ax sr ref.fasta r1.fq.gz r2.fq.gz"
     " | samtools view -S -b --threads 3"
     ' --input-fmt-option "filter=[de] < 0.2" -'
     " | samtools sort --threads 3 - > /tmp/t/tmpbam"),
    ("map_to_sam", dict(n_cpu=2, mode="-ax sr", reference="ref.fasta", reads="r1.fq",
                        sam="out/read_aln.sam"),
     "minimap2 -t 2 -p 1 -N 10 -ax sr ref.fasta r1.fq > out/read_aln.sam"),
    ("filter_sort_sam", dict(n_cpu=2, max_div=1, sam="out/read_aln.sam", bam="B"),
     "samtools view -S -b --threads 2"
     ' --input-fmt-option "filter=[de] < 1" out/read_aln.sam'
     " | samtools sort --threads 2 - > B"),
    ("map_sort_composite", dict(n_cpu=4, mode="-ax sr", reference="out/composite_reference.fasta",
                                reads="r1.fq.gz", bam="/tmp/t/tmpbam"),
     "minimap2 -t 4 -p 1 -N 10 -ax sr out/composite_reference.fasta r1.fq.gz"
     " | samtools view -S -b --threads 4 -"
     " | samtools sort --threads 4 - > /tmp/t/tmpbam"),
    ("pileup", dict(reference="ref.fasta", Q=0, q=0, l=0, S=0, V=1, T=0, bam="/tmp/t/tmpbam",
                    output="out/s1_pileup.txt"),
     "htsbox pileup -C -s 0 -f ref.fasta -Q 0 -q 0 -l 0 -S 0 -V 1 -T 0"
     " /tmp/t/tmpbam > out/s1_pileup.txt"),
    ("gzip", dict(file="out/s1_pileup.txt"), "gzip -f out/s1_pileup.txt"),
]


@pytest.mark.parametrize("name,fields,golden", GOLDEN_COMMANDS, ids=[g[0] for g in GOLDEN_COMMANDS])
def test_rendered_commands_are_the_goldens(name, fields, golden):
    """The goldens of tests/test_external_contracts.py."""
    assert port_ext.render(name, **fields) == golden == jax_ext.render(name, **fields)


def test_mode_flags_override_the_preset():
    assert port_ext._mode_flags("sr", None) == "-ax sr"
    assert port_ext._mode_flags("sr", "-x map-ont -a") == "-x map-ont -a"
    assert port_ext._reads_arg("a", None) == "a" and port_ext._reads_arg("a", "b") == "a b"


def test_require_tool_and_run_command(tmp_path):
    with pytest.raises(RuntimeError, match="not.*found on PATH"):
        port_ext.require_tool("no-such-aligner-binary")
    port_ext.require_tool("gzip")
    target = tmp_path / "x.txt"
    target.write_text("hello\n")
    assert port_ext.run_command("gzip", file=str(target)) == f"gzip -f {target}"
    assert gzip.open(str(target) + ".gz", "rt").read() == "hello\n"
    with pytest.raises(KeyError):
        port_ext.render("no_such_command")


def test_generate_reads_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    write_fasta(tmp_path / "asm.fasta", [("c1", make_genome(rng, 2000)),
                                         ("c2", make_genome(rng, 150))])
    out = {}
    for name, mod in (("port", port_ext), ("jax", jax_ext)):
        random.seed(11)
        mod.generate_reads(str(tmp_path / "asm.fasta"), str(tmp_path / f"{name}.gz"))
        out[name] = gzip.open(tmp_path / f"{name}.gz", "rt").read()
    assert out["port"] == out["jax"] and out["port"].count(">") > 60


def _recorded_run(mod, monkeypatch, tmp_path, tag, call):
    """The (command name, rendered text) sequence of one orchestration call
    with every subprocess stood in for; temp-file names are normalised."""
    log = []

    def fake_run_command(name, **fields):
        text = mod.render(name, **fields)
        log.append((name, text))
        if name == "pileup":  # the composite route reads the pileup it asked for
            with open(fields["output"], "w") as fh:
                fh.write("R1@chr1\t1\tA\t.\tA\t2:3:4\nR2@chr1\t1\tC\t.\tC\t2:5:6\n"
                         "other@chr1\t1\tC\t.\tC\t2:5:6\n")
        return text

    monkeypatch.setattr(mod, "run_command", fake_run_command)
    monkeypatch.setattr(mod, "require_tool", lambda name: None)
    outdir = tmp_path / tag
    outdir.mkdir()
    call(mod, str(outdir) + "/")
    leftovers = sorted(p.name for p in outdir.iterdir())
    norm = []
    for name, text in log:
        for word in text.split():
            if word.startswith(str(outdir)) and os.path.basename(word).startswith("tmp"):
                text = text.replace(word, "BAM")
        norm.append((name, text.replace(str(outdir), "OUT")))
    return norm, leftovers


@pytest.mark.parametrize("route", ["lowdisk", "two-step", "params", "composite"])
def test_align_and_pileup_commands_match_reference(tmp_path, monkeypatch, route):
    """The orchestration renders the same commands in the same order, and
    the composite route splits its pileup into the same per-reference files."""
    rng = np.random.default_rng(8)
    for ref in ("R1", "R2"):
        write_fasta(tmp_path / f"{ref}.fasta", [("chr1", make_genome(rng, 50))])

    def call(mod, outdir):
        if route == "composite":
            refs = {"R1": str(tmp_path / "R1.fasta"), "R2": str(tmp_path / "R2.fasta")}
            mod.align_and_pileup_composite(refs, outdir, outdir + "s1", "r1.fq", r2="r2.fq",
                                           Q=3, q=4, l=5, V=0.5, T=6, n_cpu=2)
        else:
            mod.align_and_pileup(str(tmp_path / "R1.fasta"), outdir, outdir + "s1_ref_R1",
                                 "r1.fq", max_div=0.3, Q=1, T=2, n_cpu=3,
                                 lowdisk=route != "two-step",
                                 minimap_params="-x map-ont -a" if route == "params" else None)

    got, got_files = _recorded_run(port_ext, monkeypatch, tmp_path, "port", call)
    want, want_files = _recorded_run(jax_ext, monkeypatch, tmp_path, "jax", call)
    assert got == want and got_files == want_files
    names = [n for n, _ in got]
    assert names == {"lowdisk": ["map_filter_sort", "pileup", "gzip"],
                     "params": ["map_filter_sort", "pileup", "gzip"],
                     "two-step": ["map_to_sam", "filter_sort_sam", "pileup", "gzip"],
                     "composite": ["map_sort_composite", "pileup"]}[route]
    if route == "composite":
        for ref in ("R1", "R2"):
            a = gzip.open(tmp_path / "port" / f"s1_ref_{ref}_pileup.txt.gz", "rt").read()
            b = gzip.open(tmp_path / "jax" / f"s1_ref_{ref}_pileup.txt.gz", "rt").read()
            assert a == b and a.startswith("chr1\t1\t")
    with pytest.raises(ValueError, match="Minimap2"):
        port_ext.align_and_pileup("r", "o", "p", "r1", aligner="bwa")


# -- pileup --

def _write_pileup(path, rng, contigs):
    """An htsbox-format pileup over ``contigs`` with single and mixed
    alleles, one-strand alleles, a non-ACGT reference base, an indel-like
    allele, an unknown contig, a short line and a dropped stretch."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        fh.write("ghost\t1\tA\t.\tA\t2:5:5\n")
        fh.write("short line\n")
        for contig, length in contigs.items():
            for pos in range(1, length + 1):
                if 20 <= pos < 30:
                    continue
                ref = "ACGTN"[rng.integers(0, 5)] if pos % 17 else "N"
                kind = rng.integers(0, 5)
                if kind == 0:
                    nucs, f, r = "A,G", "6,5", "7,4"
                elif kind == 1:
                    nucs, f, r = "C,T", "9,0", "8,3"  # T on one strand only
                elif kind == 2:
                    nucs, f, r = "G,+2AC", "4,2", "4,1"
                else:
                    nuc = "ACGT"[rng.integers(0, 4)]
                    nucs, f, r = nuc, str(rng.integers(0, 12)), str(rng.integers(0, 12))
                fh.write(f"{contig}\t{pos}\t{ref}\t.\t{nucs}\t2:{f}:{r}\n")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("both_strands", [True, False])
@pytest.mark.parametrize("gz", [True, False])
def test_parse_pileup_matches_reference(tmp_path, monkeypatch, gz, both_strands, native):
    rng = np.random.default_rng(9)
    contigs = {"chr2": 90, "chr1": 150}  # the genome's record order, not sorted
    path = tmp_path / ("p.txt.gz" if gz else "p.txt")
    _write_pileup(path, rng, contigs)
    want = jax_pileup.parse_pileup(path, contigs, require_both_strands=both_strands)
    if not native:
        monkeypatch.setattr(port_pileup, "get_lib", lambda: None)
    got = port_pileup.parse_pileup(path, contigs, require_both_strands=both_strands)
    assert got.shape == (240, 4) and got.dtype == np.float64
    assert np.array_equal(got, want) and got.sum() > 0
    assert not got[19:29].any() and not got[90 + 19:90 + 29].any()


@pytest.mark.parametrize("case", ["whole", "truncated", "empty"])
def test_scan_pileup_depth_matches_reference(tmp_path, case):
    rng = np.random.default_rng(10)
    path = tmp_path / "p.txt.gz"
    _write_pileup(path, rng, {"chr1": 400})
    if case == "truncated":
        data = path.read_bytes()
        path.write_bytes(data[: len(data) // 2])
    elif case == "empty":
        path.write_bytes(gzip.compress(b""))
    got, want = port_pileup.scan_pileup_depth(path), jax_pileup.scan_pileup_depth(path)
    if case == "empty":
        assert got is None and want is None
    else:
        assert got.dtype == np.int64 and np.array_equal(got, want) and len(got) > 50


# -- combine --

def _align_outputs(tmp_path, with_pileups):
    """Two sample directories as the align stage leaves them."""
    dirs = []
    for sample, seq in [("s1", "ACGTACGTAC"), ("s2", "ACNNACGTNN")]:
        d = tmp_path / sample
        d.mkdir()
        for ref in ("REFX", "REFY"):
            (d / f"{sample}_posterior_counts_ref_{ref}.fasta").write_text(
                f">{sample}_{ref}\n{seq}\n")
            if with_pileups:
                with gzip.open(d / f"{sample}_ref_{ref}_pileup.txt.gz", "wt") as fh:
                    for pos in range(1, 9):
                        fh.write(f"chr1\t{pos}\tA\t.\tA\t2:{pos % 3}:{pos % 2}\n")
        (d / f"{sample}_sourmash_hits.csv").write_text(
            ",".join(["h"] * 10) + "\n"
            '1000,0.5,0.4,0.3,x,y,z,w,sig,"REFX some species"\n'
            '900,0.4,0.3,0.2,x,y,z,w,sig,"REFY other species name"\n'
            "too,short\n")
        dirs.append(str(d))
    return dirs


@pytest.mark.parametrize("extra", [[], ["--coverage"], ["-t", "3"], ["--coverage", "-t", "2"]])
def test_combine_stage_matches_reference(tmp_path, extra):
    """tests/test_stages.py::test_combine_stage through both packages: the
    same combined_metadata.csv bytes and combined alignments, serial and on
    several workers (thread pool here, joblib there: the same order)."""
    dirs = _align_outputs(tmp_path, with_pileups=True)
    port_combine.main(["-i", *dirs, "-o", str(tmp_path / "port"), *extra])
    import sys

    argv, sys.argv = sys.argv, ["", "-i", *dirs, "-o", str(tmp_path / "jax"), *extra]
    try:
        jax_combine.main()
    finally:
        sys.argv = argv
    got = (tmp_path / "port" / "combined_metadata.csv").read_bytes()
    assert got == (tmp_path / "jax" / "combined_metadata.csv").read_bytes()
    rows = got.decode().strip().split("\n")
    assert rows[0].startswith("sample,accession,") and len(rows) == 5
    row_s2 = [r for r in rows[1:] if r.startswith("s2,REFX")][0].split(",")
    assert abs(float(row_s2[9]) - 0.4) < 1e-12 and row_s2[10] == "some species"
    assert (row_s2[6] == "NA") == ("--coverage" not in extra)
    for ref in ("REFX", "REFY"):
        a = gzip.open(tmp_path / "port" / f"{ref}_combined.fasta.gz", "rt").read()
        assert a == gzip.open(tmp_path / "jax" / f"{ref}_combined.fasta.gz", "rt").read()
        assert a == ">s1\nACGTACGTAC\n>s2\nACNNACGTNN\n"


def test_combine_takes_a_listing_file_and_rejects_bad_input(tmp_path):
    dirs = _align_outputs(tmp_path, with_pileups=False)
    listing = tmp_path / "dirs.txt"
    listing.write_text("\n".join(dirs) + "\n\n")
    port_combine.main(["-i", str(listing), "-o", str(tmp_path / "out")])
    assert (tmp_path / "out" / "REFX_combined.fasta.gz").exists()
    with open(os.path.join(dirs[0], "s1_posterior_counts_ref_REFX.fasta"), "a") as fh:
        fh.write(">second\nACGT\n")
    with pytest.raises(SystemExit):
        port_combine.main(["-i", *dirs, "-o", str(tmp_path / "out2"), "-t", "2"])
    with pytest.raises(SystemExit):
        port_combine.main(["-i", dirs[0], str(tmp_path / "missing"), "-o", str(tmp_path / "o3")])
    assert port_combine.ref_of_alignment(
        __import__("pathlib").Path("a_posterior_counts_ref_GCA_1.2.fasta.gz")) == "GCA_1.2"
