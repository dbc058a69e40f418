"""The port's ``align`` and ``pipe`` stages against tracs_tpu's on the CPU,
with the aligner subprocess stood in for by the same function in both
packages (it writes the sample's htsbox-format pileup from a known genome, as
tests/test_align_pipe.py does).  Reference selection, pileup parsing, the
coverage rules, the Dirichlet-multinomial model, the IUPAC calls, the
combined MSAs, ``distance`` and ``cluster`` all run for real.

Compared exactly: the called FASTAs (bytes), the gather hit CSVs (bytes), the
posterior CSVs (decompressed text: five decimals of float64 values that agree
at 1e-9 would differ only if a value sat within 1e-9 of a rounding boundary;
none does here), and ``pipe``'s two CSVs after sorting rows (the sample order
of the combined MSA depends on set and glob order in both packages)."""

import gzip
import io
import os
import time
import zipfile

import numpy as np
import pytest
import torch

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.ops import packing as port_packing
from tracs_tpu_torch.stages import align as port_align

jax = pytest.importorskip("jax")

from tracs_tpu import cli as jax_cli  # noqa: E402
from tracs_tpu.io.fasta import read_fasta, write_fasta  # noqa: E402
from tracs_tpu.ops import packing as jax_packing  # noqa: E402
from tracs_tpu.stages import align as jax_align  # noqa: E402

REF_LEN = 3000
MUT = {"A": "G", "C": "T", "G": "A", "T": "C"}


def ref_genome(seed=12345, L=REF_LEN):
    return "".join(np.random.default_rng(seed).choice(list("ACGT"), size=L))


def make_sample(ref, positions):
    s = list(ref)
    for p in positions:
        s[p] = MUT[s[p]]
    return "".join(s)


def write_fake_pileup(path, ref_seq, sample_seq, depth=(10, 10), contig="chr1", dropout=(),
                      thin=(), mixed=None):
    """htsbox-like pileup: contig pos ref alt nucs x:fwd:rev.  ``dropout``
    sites have no line, ``thin`` sites one read a strand, ``mixed`` sites
    {pos: second base} two alleles on both strands."""
    mixed = mixed or {}
    with gzip.open(path, "wt") as fh:
        for pos0, (rb, sb) in enumerate(zip(ref_seq, sample_seq)):
            if pos0 in dropout:
                continue
            if pos0 in mixed:
                fh.write(f"{contig}\t{pos0 + 1}\t{rb}\t.\t{sb},{mixed[pos0]}\t2:6,5:7,4\n")
            elif pos0 in thin:
                fh.write(f"{contig}\t{pos0 + 1}\t{rb}\t.\t{sb}\t2:1:1\n")
            else:
                fh.write(f"{contig}\t{pos0 + 1}\t{rb}\t.\t{sb}\t2:{depth[0]}:{depth[1]}\n")


def stand_in_aligner(ref_seq, samples, delay=0.0, **pileup_kw):
    """A stand-in for io.external.align_and_pileup that writes the sample's
    pileup instead of running minimap2 | samtools | htsbox.  ``samples`` maps
    a sample prefix to its genome; ``pileup_kw`` may map a prefix to the
    keyword arguments of its pileup."""
    def fake(reference, outdir, prefix, r1, r2=None, **kw):
        time.sleep(delay)
        sample = os.path.basename(prefix).split("_ref_")[0]
        write_fake_pileup(prefix + "_pileup.txt.gz", ref_seq, samples[sample],
                          **pileup_kw.get(sample, {}))
    return fake


def patch_both(monkeypatch, fake, gather=None):
    for mod in (port_align, jax_align):
        monkeypatch.setattr(mod, "align_and_pileup", fake)
        if gather is not None:
            monkeypatch.setattr(mod, "run_gather", lambda **kw: list(gather))


def tiny_reads(path):
    path.write_bytes(gzip.compress(b"@r1\nACGT\n+\nFFFF\n"))
    return str(path)


def run_both(tmp_path, argv_of):
    """Runs ``argv_of(outdir)`` through tracs_tpu's CLI and the port's (on
    the CPU); returns (port outdir, tracs_tpu outdir)."""
    jax_out, port_out = tmp_path / "jax_out", tmp_path / "port_out"
    jax_cli.main(argv_of(jax_out))
    port_cli.main(argv_of(port_out) + ["--device", "cpu"])
    return port_out, jax_out


def assert_same_align_outputs(port_out, jax_out, expect_files):
    """Every align output of the two directories: FASTAs and hit CSVs byte
    for byte, posterior CSVs by their decompressed text."""
    names = sorted(p.name for p in port_out.iterdir() if p.is_file())
    assert names == sorted(p.name for p in jax_out.iterdir() if p.is_file())
    assert set(expect_files) <= set(names), names
    for name in names:
        a, b = (port_out / name).read_bytes(), (jax_out / name).read_bytes()
        if name.endswith(".csv.gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        elif name.endswith("_pileup.txt.gz"):
            continue
        assert a == b, name


def make_db_zip(path, ref_fasta_path, ref_name, sbt=True):
    """Database zip layout: the genome as ``<REF>.fasta.gz``, with a dummy
    SBT member (sourmash route, stood in for) or native sketches."""
    with zipfile.ZipFile(path, "w") as z:
        if sbt:
            z.writestr("sourmashDB.sbt.zip", b"dummy")
        with open(ref_fasta_path, "rb") as fh:
            data = fh.read()
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
            gz.write(data)
        z.writestr(ref_name + ".fasta.gz", buf.getvalue())
        z.writestr("summary.tsv", f"{ref_name},{ref_name}.fasta.gz")


# -- packing helpers the align path uses --

def test_iupac_helpers_match_reference():
    for nibble in range(16):
        assert port_packing.iupac_code_for_mask(nibble) == jax_packing.iupac_code_for_mask(nibble)
    assert [port_packing.iupac_code_for_mask(n) for n in (0, 1, 3, 5, 15)] == list("XAMRN")
    nib = np.random.default_rng(0).integers(0, 16, size=500).astype(np.uint8)
    assert port_packing.nibbles_to_string(nib) == jax_packing.nibbles_to_string(nib)
    mask = np.random.default_rng(1).random((300, 4)) < 0.4
    assert port_align.nibble_sequence(mask) == jax_align.nibble_sequence(mask)


@pytest.mark.parametrize("case", ["posteriors", "one value", "zeros and ones", "one row",
                                  "many values"])
def test_posterior_csv_text_is_savetxts(tmp_path, case):
    """The table-lookup writer gives np.savetxt's text for a matrix put
    together again from its distinct values."""
    rng = np.random.default_rng(2)
    values = {"posteriors": rng.choice([0.0, 0.98765432, 0.125, 1.0, 0.000004], size=(2000, 4)),
              "one value": np.ones((7, 4)),
              "zeros and ones": rng.integers(0, 2, size=(50, 4)).astype(float),
              "one row": rng.random((1, 4)),
              "many values": rng.random((3000, 4))}[case]
    distinct, index = port_align.distinct_values(torch.from_numpy(values))
    assert index.dtype == np.int32 and np.array_equal(distinct[index], values)
    path = str(tmp_path / "p.csv.gz")
    port_align.write_posterior_csv(path, distinct, index)
    want = io.BytesIO()
    np.savetxt(want, values, delimiter=",", newline="\n", fmt="%0.5f")
    assert gzip.open(path, "rb").read() == want.getvalue() + b"\n"


@pytest.mark.parametrize("bad", [12.25, float("nan"), -0.5])
def test_posterior_csv_refuses_what_no_posterior_is(tmp_path, bad):
    distinct, index = port_align.distinct_values(torch.tensor([[0.5, bad, 0.25, 1.0]],
                                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="values in"):
        port_align.write_posterior_csv(str(tmp_path / "p.csv.gz"), distinct, index)


# -- align --

def test_align_single_ref(tmp_path, monkeypatch):
    """tests/test_align_pipe.py::test_align_single_ref."""
    ref = ref_genome()
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    sample = make_sample(ref, [100, 200, 300])
    patch_both(monkeypatch, stand_in_aligner(ref, {"s1": sample}))
    reads = tiny_reads(tmp_path / "s1.fastq.gz")
    port_out, jax_out = run_both(tmp_path, lambda out: [
        "align", "-i", reads, "--refseqs", str(tmp_path / "REF1.fasta"), "-o", str(out),
        "-p", "s1"])
    assert_same_align_outputs(port_out, jax_out, ["s1_posterior_counts_ref_REF1.fasta",
                                                  "s1_posterior_counts_ref_REF1.csv.gz"])
    (name, called), = read_fasta(port_out / "s1_posterior_counts_ref_REF1.fasta")
    assert name == "s1_REF1" and called == sample and called.count("N") == 0
    assert called[100] == MUT[ref[100]] and called[50] == ref[50]
    assert not any(p.is_dir() for p in port_out.iterdir())  # the temp dir is gone


@pytest.mark.parametrize("flags", [[], ["--keep-all"], ["--either-strand"], ["--min-cov", "2"],
                                   ["--keep-cov-outliers"], ["--error-perc", "0.2"]])
def test_align_coverage_and_mixed_sites(tmp_path, monkeypatch, flags):
    """Uncovered and thin stretches become N (the min-cov rule), mixed sites
    with two alleles on both strands an IUPAC code (the posterior rule), and
    every flag of the posterior group gives what tracs_tpu gives."""
    ref = ref_genome(7)
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    sample = make_sample(ref, [400, 900])
    mixed = {p: MUT[sample[p]] for p in range(1000, 1400, 9)}  # enough rows for the fit
    kw = dict(dropout=set(range(0, 40)), thin=set(range(60, 90)), mixed=mixed)
    patch_both(monkeypatch, stand_in_aligner(ref, {"s1": sample}, s1=kw))
    reads = tiny_reads(tmp_path / "s1.fastq.gz")
    port_out, jax_out = run_both(tmp_path, lambda out: [
        "align", "-i", reads, "--refseqs", str(tmp_path / "REF1.fasta"), "-o", str(out),
        "-p", "s1", *flags])
    assert_same_align_outputs(port_out, jax_out, ["s1_posterior_counts_ref_REF1.fasta"])
    called = list(read_fasta(port_out / "s1_posterior_counts_ref_REF1.fasta"))[0][1]
    assert set(called[:40]) == {"N"} and called[41] == ref[41]
    if "--min-cov" not in flags:  # at --min-cov 2 the threshold is raised: only parity is held
        assert set(called[60:90]) == {"N"}
        two = {frozenset("AG"): "R", frozenset("CT"): "Y"}
        assert all(called[p] == two[frozenset((sample[p], b))] for p, b in mixed.items())


def test_align_consensus_mode(tmp_path, monkeypatch):
    """tests/test_align_pipe.py::test_align_consensus_mode."""
    ref = ref_genome()
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    patch_both(monkeypatch, stand_in_aligner(ref, {"s1": make_sample(ref, [10])}))
    reads = tiny_reads(tmp_path / "s1.fastq.gz")
    port_out, jax_out = run_both(tmp_path, lambda out: [
        "align", "-i", reads, "--refseqs", str(tmp_path / "REF1.fasta"), "-o", str(out),
        "-p", "s1", "--consensus"])
    assert_same_align_outputs(port_out, jax_out, ["s1_posterior_counts_ref_REF1.fasta"])
    called = list(read_fasta(port_out / "s1_posterior_counts_ref_REF1.fasta"))[0][1]
    assert called[10] == MUT[ref[10]] and called[11] == ref[11]
    assert not (port_out / "s1_posterior_counts_ref_REF1.csv.gz").exists()


@pytest.mark.parametrize("case", ["barely covered", "mostly thin"])
def test_align_skips_a_reference_without_coverage(tmp_path, monkeypatch, case):
    """Less than a quarter of the genome at the minimum coverage: no call."""
    ref = ref_genome(3)
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    kw = (dict(dropout=set(range(600, REF_LEN))) if case == "barely covered"
          else dict(thin=set(range(500, REF_LEN))))
    patch_both(monkeypatch, stand_in_aligner(ref, {"s1": ref}, s1=kw))
    reads = tiny_reads(tmp_path / "s1.fastq.gz")
    port_out, jax_out = run_both(tmp_path, lambda out: [
        "align", "-i", reads, "--refseqs", str(tmp_path / "REF1.fasta"), "-o", str(out),
        "-p", "s1"])
    assert_same_align_outputs(port_out, jax_out, [])
    assert not list(port_out.glob("*.fasta"))


def test_align_two_contigs_and_default_prefix(tmp_path, monkeypatch):
    """A reference of two records: the pileup's contigs are laid out in the
    genome's record order; the prefix defaults to the read file's stem."""
    rng = np.random.default_rng(4)
    c1, c2 = ("".join(rng.choice(list("ACGT"), size=n)) for n in (700, 500))
    write_fasta(tmp_path / "REF2.fna", [("ctgB", c1), ("ctgA", c2)])
    s1, s2 = make_sample(c1, [5, 77]), make_sample(c2, [400])

    def fake(reference, outdir, prefix, r1, r2=None, **kw):
        for contig, ref_seq, seq, mode in (("ctgA", c2, s2, "wt"), ("ctgB", c1, s1, "at")):
            with gzip.open(prefix + "_pileup.txt.gz", mode) as fh:
                for pos0, (rb, sb) in enumerate(zip(ref_seq, seq)):
                    fh.write(f"{contig}\t{pos0 + 1}\t{rb}\t.\t{sb}\t2:9:8\n")

    patch_both(monkeypatch, fake)
    reads = tiny_reads(tmp_path / "isolate7.fastq.gz")
    port_out, jax_out = run_both(tmp_path, lambda out: [
        "align", "-i", reads, "--refseqs", str(tmp_path / "REF2.fna"), "-o", str(out)])
    name = "isolate7.fastq_posterior_counts_ref_REF2.fasta"
    assert_same_align_outputs(port_out, jax_out, [name])
    assert list(read_fasta(port_out / name))[0][1] == s1 + s2


def test_align_composite_calls_the_composite_aligner(tmp_path, monkeypatch):
    """--composite makes one aligner call for all references, with the
    arguments tracs_tpu gives it."""
    ref = ref_genome(5)
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    seen = {}

    def recorder(tag):
        def fake(references, outdir, prefix, r1, **kw):
            seen[tag] = (dict(references), os.path.basename(prefix), os.path.basename(r1), kw)
            for r in references:
                write_fake_pileup(f"{prefix}_ref_{r}_pileup.txt.gz", ref, ref)
        return fake

    import tracs_tpu.io.external as jax_ext

    monkeypatch.setattr(port_align, "align_and_pileup_composite", recorder("port"))
    monkeypatch.setattr(jax_ext, "align_and_pileup_composite", recorder("jax"))
    reads = tiny_reads(tmp_path / "s1.fastq.gz")
    port_out, jax_out = run_both(tmp_path, lambda out: [
        "align", "-i", reads, "--refseqs", str(tmp_path / "REF1.fasta"), "-o", str(out),
        "-p", "s1", "--composite", "-V", "0.4", "--trim", "3", "-t", "2"])
    assert seen["port"] == seen["jax"] and seen["port"][3]["V"] == 0.4
    assert_same_align_outputs(port_out, jax_out, ["s1_posterior_counts_ref_REF1.fasta"])


def test_align_passes_the_aligner_the_reference_arguments(tmp_path, monkeypatch):
    """The per-reference aligner call: the same positional and keyword
    arguments from both packages (V pinned to 1, max_div from -V)."""
    ref = ref_genome(6)
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    seen = []
    inner = stand_in_aligner(ref, {"s1": ref})

    def fake(reference, outdir, prefix, r1, **kw):
        seen.append((os.path.basename(reference), os.path.basename(prefix),
                     os.path.basename(r1), sorted(kw.items())))
        inner(reference, outdir, prefix, r1, **kw)

    patch_both(monkeypatch, fake)
    r1, r2 = tiny_reads(tmp_path / "s1_1.fastq.gz"), tiny_reads(tmp_path / "s1_2.fastq.gz")
    run_both(tmp_path, lambda out: [
        "align", "-i", r1, r2, "--refseqs", str(tmp_path / "REF1.fasta"), "-o", str(out),
        "-p", "s1", "-V", "0.25", "-Q", "7", "-q", "3", "-l", "50", "--trim", "2",
        "--minimap_preset", "map-ont"])
    assert len(seen) == 2 and seen[0] == seen[1]
    kw = dict(seen[0][3])
    assert kw["V"] == 1 and kw["max_div"] == 0.25 and kw["minimap_preset"] == "map-ont"
    assert os.path.basename(kw["r2"]) == "s1_2.fastq.gz"


def test_align_shreds_a_bare_assembly(tmp_path, monkeypatch):
    """A single .fasta input is shredded into pseudo-reads first."""
    ref = ref_genome(8)
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    write_fasta(tmp_path / "asm.fasta", [("contig", ref[:900])])
    seen = []

    def fake(reference, outdir, prefix, r1, r2=None, **kw):
        with gzip.open(r1, "rt") as fh:
            seen.append((os.path.basename(r1), r2, fh.read().count(">")))
        write_fake_pileup(prefix + "_pileup.txt.gz", ref, ref)

    monkeypatch.setattr(port_align, "align_and_pileup", fake)
    port_cli.main(["align", "-i", str(tmp_path / "asm.fasta"), "--refseqs",
                   str(tmp_path / "REF1.fasta"), "-o", str(tmp_path / "out"), "--device", "cpu"])
    assert seen == [("simulated_asm.fasta.gz", None, 31)]


@pytest.mark.parametrize("argv,message", [
    (["-i", "x.fq"], "either a database or reference"),
    (["-i", "x.fq", "--database", "db.tar"], "must be a zip"),
    (["-i", "x.fq", "--refseqs", "genomes.txt"], "must be a fasta"),
])
def test_align_rejects_bad_inputs(tmp_path, caplog, argv, message):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["align", *argv, "-o", str(tmp_path / "out"), "--device", "cpu"])
    assert exc.value.code == 1 and message in caplog.text


def test_genbank_download_is_gated():
    with pytest.raises(RuntimeError, match="ncbi_genome_download"):
        port_align.fetch_genbank_assembly("GCA_000000000.1", "/nonexistent")
    assert port_align.download_ref is port_align.fetch_genbank_assembly


def test_gtdb_fasta_path(tmp_path):
    nested = tmp_path / "GCA" / "000" / "123" / "456"
    nested.mkdir(parents=True)
    (nested / "GCA_000123456.1_genomic.fna.gz").write_bytes(b"")
    assert port_align.gtdb_fasta_path(str(tmp_path), "GCA_000123456.1") == str(
        nested / "GCA_000123456.1_genomic.fna.gz")
    with pytest.raises(ValueError):
        port_align.find_fasta(str(tmp_path), "GCA_999999999.1")


def test_native_sketch_database_to_align(tmp_path, monkeypatch):
    """tests/test_align_pipe.py::test_build_db_to_align_native_sketch_e2e
    without build-db: the database zip carries native sketches and the genomes
    and no SBT, so both packages select the reference with the real
    FracMinHash gather; only the aligner is stood in for."""
    rng = np.random.default_rng(9)
    L = 60_000
    genomes = {name: "".join(rng.choice(list("ACGT"), size=L)) for name in ("GENOME1", "GENOME2")}
    from tracs_tpu_torch.sketch import write_db_sketches

    db = str(tmp_path / "refdb.zip")
    inputs = []
    with zipfile.ZipFile(db, "w") as z:
        for name, seq in genomes.items():
            write_fasta(tmp_path / f"{name}.fasta", [("chr1", seq)])
            z.writestr(name + ".fasta.gz", gzip.compress((tmp_path / f"{name}.fasta").read_bytes()))
            inputs.append((str(tmp_path / f"{name}.fasta"), name))
    write_db_sketches(db, inputs, scaled=100)
    sample = make_sample(genomes["GENOME2"], [77, 1234, 40_000])
    reads = tmp_path / "s1.fastq.gz"
    with gzip.open(reads, "wt") as fh:
        fh.write(f"@r1\n{sample}\n+\n{'F' * L}\n")
    patch_both(monkeypatch, stand_in_aligner(genomes["GENOME2"], {"s1": sample}))
    port_out, jax_out = run_both(tmp_path, lambda out: [
        "align", "-i", str(reads), "--database", db, "-o", str(out), "-p", "s1",
        "--min-cov", "2"])
    assert_same_align_outputs(port_out, jax_out, ["s1_sourmash_hits.csv",
                                                  "s1_posterior_counts_ref_GENOME2.fasta"])
    assert not (port_out / "s1_posterior_counts_ref_GENOME1.fasta").exists()
    called = list(read_fasta(port_out / "s1_posterior_counts_ref_GENOME2.fasta"))[0][1]
    assert called == sample


# -- pipe: the slice as a whole --

def _pipe_inputs(tmp_path, ref, samples, sbt=True):
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    make_db_zip(tmp_path / "db.zip", tmp_path / "REF1.fasta", "REF1", sbt=sbt)
    with open(tmp_path / "input.tsv", "w") as fh:
        fh.write("prefix\tr1\n")
        for name in samples:
            fh.write(f"{name}\t{tiny_reads(tmp_path / f'{name}.fastq.gz')}\n")
    return str(tmp_path / "input.tsv"), str(tmp_path / "db.zip")


def _sorted_rows(path):
    lines = open(path).read().splitlines()
    return lines[0], sorted(lines[1:])


def _pair_key(row):
    return frozenset((row[0].split("_")[0], row[1].split("_")[0]))


def assert_same_pipe_outputs(port_out, jax_out, samples):
    """Called FASTAs byte for byte, distances after sorting rows with each
    pair keyed without regard to its order, clusters as the same partition."""
    for name in samples:
        assert_same_align_outputs(port_out / name, jax_out / name,
                                  [f"{name}_posterior_counts_ref_REF1.fasta"])
    got_h, got = _sorted_rows(port_out / "transmission_distances.csv")
    want_h, want = _sorted_rows(jax_out / "transmission_distances.csv")
    assert got_h == want_h
    # the order of the samples within the combined MSA follows set and glob
    # order, so a pair may come as (a, b) in one package and (b, a) in the other
    def keyed(rows):
        return sorted((sorted(r.split(",")[:2]), r.split(",")[2:]) for r in rows)
    assert keyed(got) == keyed(want) and len(got) > 0

    def partition(path):
        groups = {}
        for line in open(path).read().splitlines()[1:]:
            sample, label = line.split(",")
            groups.setdefault(label, set()).add(sample)
        return sorted(sorted(g) for g in groups.values())
    assert partition(port_out / "transmission_clusters.csv") == partition(
        jax_out / "transmission_clusters.csv")


@pytest.mark.parametrize("extra", [[], ["--filter"], ["-D", "10", "-c", "3"],
                                   ["--cluster_distance", "filter", "--filter", "-c", "5"]])
def test_pipe_end_to_end(tmp_path, monkeypatch, extra):
    """tests/test_align_pipe.py::test_pipe_end_to_end through both CLIs."""
    ref = ref_genome()
    samples = {"close1": make_sample(ref, [100, 200]), "close2": make_sample(ref, [100, 250]),
               "far1": make_sample(ref, list(range(500, 560)))}
    tsv, db = _pipe_inputs(tmp_path, ref, samples)
    patch_both(monkeypatch, stand_in_aligner(ref, samples), gather=["REF1"])
    common = ["pipe", "-i", tsv, "--database", db, "--min-cov", "2", *extra]
    jax_out, port_out = tmp_path / "jax_out", tmp_path / "port_out"
    jax_cli.main([*common, "-o", str(jax_out), "--mesh", "off"])
    port_cli.main([*common, "-o", str(port_out), "--device", "cpu"])  # --mesh unset: one device
    assert_same_pipe_outputs(port_out, jax_out, samples)

    rows = [ln.split(",") for ln in open(port_out / "transmission_distances.csv").readlines()[1:]]
    by_pair = {_pair_key(r): r for r in rows}
    assert int(by_pair[frozenset(("close1", "close2"))][3]) == 2
    if "-D" not in extra:
        assert int(by_pair[frozenset(("close1", "far1"))][3]) == 62
    labels = {k.split("_")[0]: v for k, v in (
        ln.strip().split(",") for ln in open(port_out / "transmission_clusters.csv").readlines()[1:])}
    assert labels["close1"] == labels["close2"]
    if "-D" not in extra:
        # the filter takes far1's 60 adjacent SNPs for a recombination tract
        assert (labels["far1"] != labels["close1"]) == ("--cluster_distance" not in extra)
    else:
        assert "far1" not in labels  # no row under -D 10 names it


def test_pipe_native_gather_and_two_clusters(tmp_path, monkeypatch):
    """``pipe`` with a sketch-only database (the real native gather a
    sample), thin and mixed sites, and two planted clusters."""
    rng = np.random.default_rng(10)
    L = 60_000
    ref = "".join(rng.choice(list("ACGT"), size=L))
    write_fasta(tmp_path / "REF1.fasta", [("chr1", ref)])
    from tracs_tpu_torch.sketch import write_db_sketches

    db = str(tmp_path / "db.zip")
    with zipfile.ZipFile(db, "w") as z:
        z.writestr("REF1.fasta.gz", gzip.compress((tmp_path / "REF1.fasta").read_bytes()))
    write_db_sketches(db, [(str(tmp_path / "REF1.fasta"), "REF1")], scaled=100)
    far = [int(p) for p in rng.choice(L, size=300, replace=False)]
    samples = {"a1": make_sample(ref, [10, 20]), "a2": make_sample(ref, [10, 30, 40]),
               "b1": make_sample(ref, far), "b2": make_sample(ref, far + [55_555])}
    pileup_kw = {"a1": dict(thin=set(range(1000, 1200))),
                 "b2": dict(mixed={p: MUT[samples["b2"][p]] for p in range(2000, 2600, 7)})}
    with open(tmp_path / "input.tsv", "w") as fh:
        fh.write("prefix\tr1\n")
        for name, seq in samples.items():
            with gzip.open(tmp_path / f"{name}.fastq.gz", "wt") as rf:
                rf.write(f"@{name}\n{seq}\n+\n{'F' * L}\n")
            fh.write(f"{name}\t{tmp_path / f'{name}.fastq.gz'}\n")
    patch_both(monkeypatch, stand_in_aligner(ref, samples, **pileup_kw))
    common = ["pipe", "-i", str(tmp_path / "input.tsv"), "--database", db, "-D", "50", "-c", "20"]
    jax_out, port_out = tmp_path / "jax_out", tmp_path / "port_out"
    jax_cli.main([*common, "-o", str(jax_out), "--mesh", "off"])
    port_cli.main([*common, "-o", str(port_out), "--device", "cpu", "--mesh", "off"])
    assert_same_pipe_outputs(port_out, jax_out, samples)
    for name in samples:
        assert (port_out / name / f"{name}_sourmash_hits.csv").read_bytes() == (
            jax_out / name / f"{name}_sourmash_hits.csv").read_bytes()
    rows = [ln.split(",") for ln in open(port_out / "transmission_distances.csv").readlines()[1:]]
    # thin sites read N and mixed sites an IUPAC code holding the partner's base: no mismatch
    assert {tuple(sorted(_pair_key(r))): int(r[3]) for r in rows} == {("a1", "a2"): 3,
                                                                      ("b1", "b2"): 1}


def test_pipe_parallel_ingest_scales(tmp_path, monkeypatch):
    """tests/test_align_pipe.py::test_pipe_parallel_ingest_scales on the port:
    4 workers over 4 samples behind a stand-in that sleeps beat serial by 2x
    and give the same rows."""
    ref = ref_genome()
    samples = {f"s{k}": make_sample(ref, [100 + 10 * k]) for k in range(4)}
    tsv, db = _pipe_inputs(tmp_path, ref, samples)
    monkeypatch.setattr(port_align, "align_and_pileup", stand_in_aligner(ref, samples, delay=0.5))
    monkeypatch.setattr(port_align, "run_gather", lambda **kw: ["REF1"])

    def run(outdir, workers):
        t0 = time.time()
        port_cli.main(["pipe", "-i", tsv, "--database", db, "-o", str(outdir), "--min-cov", "2",
                       "--align-workers", str(workers), "--device", "cpu"])
        return time.time() - t0

    t_serial, t_parallel = run(tmp_path / "serial", 1), run(tmp_path / "parallel", 4)
    assert t_serial / t_parallel > 2.0, (t_serial, t_parallel)
    assert _sorted_rows(tmp_path / "serial" / "transmission_distances.csv")[1] == _sorted_rows(
        tmp_path / "parallel" / "transmission_distances.csv")[1]


@pytest.mark.parametrize("bad", ["repeated prefix", "missing reads"])
def test_pipe_validates_its_input(tmp_path, bad):
    reads = tiny_reads(tmp_path / "a.fastq.gz")
    with open(tmp_path / "input.tsv", "w") as fh:
        fh.write("prefix\tr1\n")
        fh.write(f"a\t{reads}\n")
        fh.write(f"a\t{reads}\n" if bad == "repeated prefix" else f"b\t{tmp_path / 'none.fq'}\n")
    with pytest.raises(ValueError, match="Repeated" if bad == "repeated prefix" else "not exist"):
        port_cli.main(["pipe", "-i", str(tmp_path / "input.tsv"), "--database", "db.zip", "-o",
                       str(tmp_path / "out"), "--device", "cpu"])


def test_pipe_mesh_shape_needs_its_world(tmp_path, monkeypatch):
    """``pipe --mesh 2x1`` in one process raises the distance stage's
    world-size error, before any sample is aligned."""
    ref = ref_genome()
    samples = {"s0": ref, "s1": make_sample(ref, [5])}
    tsv, db = _pipe_inputs(tmp_path, ref, samples)
    calls = []
    aligner = stand_in_aligner(ref, samples)
    monkeypatch.setattr(port_align, "align_and_pileup",
                        lambda *a, **k: (calls.append(1), aligner(*a, **k)))
    monkeypatch.setattr(port_align, "run_gather", lambda **kw: ["REF1"])
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 processes, the world has 1"):
        port_cli.main(["pipe", "-i", tsv, "--database", db, "-o", str(tmp_path / "out"),
                       "--min-cov", "2", "--device", "cpu", "--mesh", "2x1"])
    assert not calls


@pytest.mark.parametrize("stage", ["align", "pipe"])
def test_default_device_needs_a_card(tmp_path, stage):
    """Without --device cpu both stages exit 1 here with the message of
    DeviceUnavailableError, before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    reads = tiny_reads(tmp_path / "a.fastq.gz")
    (tmp_path / "input.tsv").write_text(f"prefix\tr1\na\t{reads}\n")
    argv = (["align", "-i", reads, "--refseqs", str(tmp_path / "r.fasta")] if stage == "align"
            else ["pipe", "-i", str(tmp_path / "input.tsv"), "--database", "db.zip"])
    with pytest.raises(SystemExit) as exc:
        port_cli.main([*argv, "-o", str(tmp_path / "out")])
    assert "CUDA" in str(exc.value.code) and "--device cpu" in str(exc.value.code)
    assert not (tmp_path / "out").exists()
