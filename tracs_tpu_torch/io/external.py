"""External-tool contracts: sourmash, minimap2, samtools, htsbox
(counterpart of tracs_tpu/io/external.py; pure host code).

The whole tool surface is ONE declarative table (``COMMANDS``): each entry
names the binaries involved, the shell template, the kwarg that holds the
file the command must produce, and a one-line purpose.  The pipeline stages
render and run entries from the table.

The rendered strings are the tool CONTRACT: they stay byte-identical to the
original TRACS pipeline's invocations (tracs/utils.py:11-83,
tracs/pileup.py:115-219; pinned against tracs_tpu's table by
tests/test_torch_sketch_external.py); everything around them (orchestration,
selection logic, file handling) is this package's own.
"""

from __future__ import annotations

import gzip
import logging
import os
import random
import shutil
import subprocess
import tempfile
from dataclasses import dataclass

from tracs_tpu_torch.io.fasta import read_fasta

_RC = str.maketrans("ACGTMRWSYKVHDBNacgtmrwsykvhdbn", "TGCAKYWSRMBDHVNtgcakywsrmbdhvn")


# ---------------------------------------------------------------------------
# the command-contract table
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ToolCommand:
    """One external-tool invocation contract."""

    binaries: tuple[str, ...]  # executables that must be on PATH
    template: str              # shell template; fields filled by render()
    output_field: str | None   # kwarg naming the file the command produces
    about: str                 # one-line purpose (doctor report)


#: binary -> (version-probe command or None, which stages need it)
VERSION_PROBES: dict[str, tuple[str | None, str]] = {
    "sourmash": ("sourmash --version", "align/pipe/build-db reference selection"),
    "minimap2": ("minimap2 --version", "align/pipe read mapping"),
    "samtools": ("samtools --version", "align/pipe BAM filter+sort"),
    "htsbox": (None, "align/pipe pileup generation"),  # no --version flag
    "gzip": ("gzip --version", "align pileup compression"),
}


COMMANDS: dict[str, ToolCommand] = {
    "sourmash_sketch": ToolCommand(
        binaries=("sourmash",),
        template=(
            "sourmash sketch dna --merge {prefix}"
            " -p scaled={scaled},k={ksize},noabund -o {output} {inputs}"
        ),
        output_field="output",
        about="FracMinHash sketch of the query reads/assembly",
    ),
    "sourmash_gather": ToolCommand(
        binaries=("sourmash",),
        template=(
            "sourmash gather -o {output} --threshold-bp {threshold_bp}"
            " --ignore-abundance {query_sig} {database}"
        ),
        output_field="output",
        about="rank database references by containment of the query sketch",
    ),
    # map + divergence-filter + coordinate-sort, piped (the low-disk default)
    "map_filter_sort": ToolCommand(
        binaries=("minimap2", "samtools"),
        template=(
            "minimap2 -t {n_cpu} -p 1 -N 10 {mode} {reference} {reads}"
            " | samtools view -S -b --threads {n_cpu}"
            ' --input-fmt-option "filter=[de] < {max_div}" -'
            " | samtools sort --threads {n_cpu} - > {bam}"
        ),
        output_field="bam",
        about="align reads and keep sub-divergence alignments, sorted BAM",
    ),
    # two-step variant (lowdisk=False): SAM to disk, then filter+sort
    "map_to_sam": ToolCommand(
        binaries=("minimap2",),
        template="minimap2 -t {n_cpu} -p 1 -N 10 {mode} {reference} {reads} > {sam}",
        output_field="sam",
        about="align reads to SAM on disk",
    ),
    "filter_sort_sam": ToolCommand(
        binaries=("samtools",),
        template=(
            "samtools view -S -b --threads {n_cpu}"
            ' --input-fmt-option "filter=[de] < {max_div}" {sam}'
            " | samtools sort --threads {n_cpu} - > {bam}"
        ),
        output_field="bam",
        about="divergence-filter + sort an on-disk SAM",
    ),
    # composite mode maps once against all references; no divergence filter
    # (reference tracs/pileup.py:60-74 composite path)
    "map_sort_composite": ToolCommand(
        binaries=("minimap2", "samtools"),
        template=(
            "minimap2 -t {n_cpu} -p 1 -N 10 {mode} {reference} {reads}"
            " | samtools view -S -b --threads {n_cpu} -"
            " | samtools sort --threads {n_cpu} - > {bam}"
        ),
        output_field="bam",
        about="composite-reference align + sort (single aligner pass)",
    ),
    "pileup": ToolCommand(
        binaries=("htsbox",),
        template=(
            "htsbox pileup -C -s 0 -f {reference}"
            " -Q {Q} -q {q} -l {l} -S {S} -V {V} -T {T} {bam} > {output}"
        ),
        output_field="output",
        about="per-site allele counts from the sorted BAM",
    ),
    "gzip": ToolCommand(
        binaries=("gzip",),
        template="gzip -f {file}",
        output_field=None,
        about="compress the pileup text in place",
    ),
}


def require_tool(name: str) -> None:
    if shutil.which(name) is None:
        raise RuntimeError(
            f"External tool {name!r} is required for this stage but was not "
            f"found on PATH. Install it or supply pre-computed inputs "
            f"(pileups / MSAs) to the downstream stages."
        )


def render(name: str, **fields) -> str:
    """Fill a COMMANDS template.  Raises KeyError on unknown entries and
    a clear error on missing fields — templates are the single source of
    truth for every flag the pipeline passes to an external tool."""
    return COMMANDS[name].template.format(**fields)


def run(cmd: str) -> None:
    logging.info("running cmd: %s", cmd)
    subprocess.run(cmd, shell=True, check=True)


def run_command(name: str, **fields) -> str:
    """Render a table entry, check its binaries, run it, and verify the
    declared output file exists and is non-empty.  Returns the rendered
    command string (doctor's flag-drift probe reports it on failure)."""
    spec = COMMANDS[name]
    for binary in spec.binaries:
        require_tool(binary)
    cmd = render(name, **fields)
    run(cmd)
    if spec.output_field is not None:
        out = fields[spec.output_field]
        # existence only: a zero-byte output can be legitimate (e.g. a
        # pileup where no read passed the divergence/quality filters for
        # one reference — the align stage handles zero coverage itself)
        if not os.path.exists(out):
            raise RuntimeError(
                f"{name}: expected output {out!r} was not produced "
                f"(command: {cmd!r})"
            )
    return cmd


def _mode_flags(minimap_preset: str, minimap_params: str | None) -> str:
    """minimap2 mapping-mode flags: explicit params override the preset."""
    return minimap_params if minimap_params is not None else "-ax " + minimap_preset


def _reads_arg(r1: str, r2: str | None) -> str:
    return r1 if r2 is None else r1 + " " + r2


# ---------------------------------------------------------------------------
# sourmash (reference selection)
# ---------------------------------------------------------------------------

def run_sketch(input_files, prefix, output, ksize=51, scaled=10000):
    logging.info("sketching input files...")
    run_command(
        "sourmash_sketch",
        prefix=prefix,
        scaled=scaled,
        ksize=ksize,
        output=output,
        inputs=" ".join(input_files),
    )


def run_gather(
    input_files,
    databasefile,
    output,
    temp_dir,
    ksize=51,
    scaled=10000,
    threshold_bp=50000,
    max_hits=99999,
    p_match=0.1,
    cache_size=0,
):
    """sourmash gather + the reference's hit-selection rule: keep references
    with f_unique_to_query >= p_match, or within 98% of the previous hit's
    coverage while the run of such hits is unbroken (reference
    tracs/utils.py:70-82)."""
    run_sketch(
        input_files=input_files,
        prefix="query",
        output=temp_dir + "query.sig",
        ksize=ksize,
        scaled=scaled,
    )

    logging.info("finding references...")
    run_command(
        "sourmash_gather",
        output=output + ".csv",
        threshold_bp=threshold_bp,
        query_sig=temp_dir + "query.sig",
        database=databasefile,
    )

    potential = []
    with open(output + ".csv", "r") as infile:
        next(infile)
        for line in infile:
            line = line.strip().split(",")
            line[2] = float(line[2])
            line[0] = float(line[0])
            potential.append(line)

    potential = sorted(potential, reverse=True)

    references = []
    prev = True
    pcov = potential[0][0]
    for line in potential:
        if (line[2] >= p_match) or (prev and (line[0] / pcov >= 0.98)):
            logging.debug("%s", line)
            logging.info("Using reference: %s", line[8])
            references.append(line[9])
        else:
            prev = False
        pcov = line[0]

    return references


# ---------------------------------------------------------------------------
# read simulation (assembly shredding)
# ---------------------------------------------------------------------------

def generate_reads(fasta, outputfile, coverage=10, read_length=300):
    """Shred an assembly into pseudo-reads for alignment (reference
    tracs/utils.py:102-117: ~coverage x, alternating strands)."""
    with gzip.open(outputfile, "wt") as outfile:
        for name, seq in read_fasta(fasta):
            seq_length = len(seq)
            forward = seq
            reverse = seq.translate(_RC)[::-1]
            nreads = max(coverage + 10, int((seq_length / read_length) * coverage + 1))
            for i in range(nreads):
                start = random.randint(0, max(0, seq_length - read_length))
                if i % 2 == 0:
                    r = forward[start : (start + read_length)]
                else:
                    r = reverse[start : (start + read_length)]
                outfile.write(f">{name}_read{i}\n{r}\n")
    return


# ---------------------------------------------------------------------------
# alignment + pileup orchestration
# ---------------------------------------------------------------------------

def _check_aligner(aligner: str) -> None:
    if aligner != "minimap2":
        raise ValueError("Minimap2 is the only currently supported aligner!")


def align_and_pileup(
    reference,
    outdir,
    prefix,
    r1,
    r2=None,
    aligner="minimap2",
    minimap_preset="sr",
    minimap_params=None,
    max_div=1,
    Q=0,  # minimum base quality
    q=0,  # minimum mapping quality
    l=0,  # minimum query length
    S=0,  # minimum supplementary alignment length
    V=1,  # ignore queries with per-base divergence > FLOAT
    T=0,  # ignore bases within INT-bp of either end of a read
    n_cpu=1,
    lowdisk=True,
):
    """map_filter_sort (or map_to_sam + filter_sort_sam when lowdisk=False)
    -> pileup -> gzip, straight off the COMMANDS table (reference command
    lines: tracs/pileup.py:115-219; the duplicated sort rerun at
    pileup.py:191-193 is intentionally not reproduced)."""
    _check_aligner(aligner)
    for tool in ("minimap2", "samtools", "htsbox"):
        require_tool(tool)  # fail fast, before any work
    logging.info("Generating alignment and pileup...")

    bam = tempfile.NamedTemporaryFile(delete=False, dir=outdir)
    bam.close()
    common = dict(
        n_cpu=n_cpu,
        mode=_mode_flags(minimap_preset, minimap_params),
        reference=reference,
        reads=_reads_arg(r1, r2),
    )
    if lowdisk:
        run_command("map_filter_sort", max_div=max_div, bam=bam.name, **common)
    else:
        sam = outdir + "read_aln.sam"
        run_command("map_to_sam", sam=sam, **common)
        run_command(
            "filter_sort_sam", n_cpu=n_cpu, max_div=max_div, sam=sam, bam=bam.name
        )

    run_command(
        "pileup",
        reference=reference,
        Q=Q, q=q, l=l, S=S, V=V, T=T,
        bam=bam.name,
        output=prefix + "_pileup.txt",
    )
    run_command("gzip", file=prefix + "_pileup.txt")

    os.remove(bam.name)
    return


def align_and_pileup_composite(
    references: dict,
    outdir,
    prefix,
    r1,
    r2=None,
    aligner="minimap2",
    minimap_preset="sr",
    minimap_params=None,
    Q=0,
    q=0,
    l=0,
    S=0,
    V=1,
    T=0,
    n_cpu=1,
    lowdisk=True,
):
    """Composite-reference mode (reference tracs/pileup.py:9-112): all
    reference genomes are concatenated with ``ref@contig`` renaming, reads
    are aligned ONCE against the composite, and the pileup is split back out
    per reference.  One aligner pass instead of one per reference — the
    better default for metagenomic samples hitting many references."""
    _check_aligner(aligner)
    for tool in ("minimap2", "samtools", "htsbox"):
        require_tool(tool)  # fail fast, before any work
    logging.info("Generating composite alignment and pileup...")

    composite = os.path.join(outdir, "composite_reference.fasta")
    with open(composite, "w") as outfile:
        for ref, path in references.items():
            for name, seq in read_fasta(path):
                outfile.write(">" + str(ref) + "@" + name + "\n" + seq + "\n")

    bam = tempfile.NamedTemporaryFile(delete=False, dir=outdir)
    bam.close()
    run_command(
        "map_sort_composite",
        n_cpu=n_cpu,
        mode=_mode_flags(minimap_preset, minimap_params),
        reference=composite,
        reads=_reads_arg(r1, r2),
        bam=bam.name,
    )

    pile = os.path.join(outdir, "composite_pileup.txt")
    run_command(
        "pileup",
        reference=composite,
        Q=Q, q=q, l=l, S=S, V=V, T=T,
        bam=bam.name,
        output=pile,
    )

    # split per reference, stripping the ref@ prefix back off contig names
    writers = {}
    try:
        for ref in references:
            writers[str(ref)] = gzip.open(
                prefix + "_ref_" + str(ref) + "_pileup.txt.gz", "wt"
            )
        with open(pile, "r") as infile:
            for line in infile:
                head, _, rest = line.partition("@")
                w = writers.get(head)
                if w is not None:
                    w.write(rest)
    finally:
        for w in writers.values():
            w.close()

    os.remove(bam.name)
    return
