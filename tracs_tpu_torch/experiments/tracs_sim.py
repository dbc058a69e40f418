"""Simulation harness of the port: ground-truth transmission pairs for
accuracy runs (counterpart of the JAX package's ``scripts/tracs_sim.py``,
which follows the reference's ``scripts/tracs-sim.py``).

Picks a "transmission genome", places exactly ``--dist`` mutations split
between two copies of it, mixes each sample's genomes by Dirichlet
proportions, simulates reads and writes a ``_dist_props.csv`` truth table and
an ``input_data.tsv`` for ``pipe``.  Reads come from ``art_illumina`` when it
is on PATH (``--simulator auto`` or ``art``); otherwise, or with
``--simulator builtin``, from a built-in uniform-coverage simulator with a
per-base error rate.  Host only: no tensor work, so no ``--device``.  At one
seed it writes the bytes ``scripts/tracs_sim.py`` writes (the gzip headers
carry the write time).

    python -m tracs_tpu_torch.experiments.tracs_sim --genomes ref1.fasta ref2.fasta \\
        --outdir sim_out --n-samples 4 --dist 10 --coverage 20
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import subprocess

import numpy as np

from tracs_tpu_torch.io.fasta import read_fasta, write_fasta

MUT_CHOICES = {
    "A": "CGT", "C": "AGT", "G": "ACT", "T": "ACG",
}
_RC = str.maketrans("ACGTacgt", "TGCAtgca")


def generate_genome_pair(seq: str, d: int, rng) -> tuple[str, str, int]:
    """Mutate exactly d random sites, split between two copies (reference
    tracs-sim.py:10-46).  Returns (copyA, copyB, d)."""
    L = len(seq)
    sites = rng.choice(L, size=d, replace=False)
    a = list(seq)
    b = list(seq)
    for i, s in enumerate(sites):
        base = seq[s].upper()
        if base not in MUT_CHOICES:
            continue
        new = MUT_CHOICES[base][rng.integers(0, 3)]
        if i % 2 == 0:
            a[s] = new
        else:
            b[s] = new
    return "".join(a), "".join(b), d


def simulate_reads_builtin(
    genome: str, out_r1, out_r2, coverage: float, read_length: int,
    error_rate: float, rng, name: str = "sim",
):
    """Uniform paired-end-ish read simulator (the stand-in for art_illumina),
    appending to gzipped FASTQs."""
    L = len(genome)
    n_reads = max(10, int(L * coverage / (2 * read_length)))
    rc = genome.translate(_RC)[::-1]
    bases = np.frombuffer(b"ACGT", dtype="S1")
    with gzip.open(out_r1, "at") as f1, gzip.open(out_r2, "at") as f2:
        for i in range(n_reads):
            start = int(rng.integers(0, max(1, L - 2 * read_length)))
            r1 = genome[start : start + read_length]
            r2 = rc[L - (start + 2 * read_length) : L - (start + read_length)]
            outs = []
            for r in (r1, r2):
                arr = np.frombuffer(r.upper().encode(), dtype="S1").copy()
                errs = np.nonzero(rng.random(len(arr)) < error_rate)[0]
                if len(errs):
                    arr[errs] = bases[rng.integers(0, 4, size=len(errs))]
                outs.append(arr.tobytes().decode())
            q = "I" * len(outs[0])
            f1.write(f"@{name}_r{i}/1\n{outs[0]}\n+\n{q}\n")
            q = "I" * len(outs[1])
            f2.write(f"@{name}_r{i}/2\n{outs[1]}\n+\n{q}\n")


def simulate_reads(genome_path, prefix, coverage, read_length, error_rate,
                   rng, simulator="auto"):
    """Reads of the genomes in ``genome_path`` appended to
    ``<prefix>_R1.fastq.gz`` and ``_R2``: art_illumina's when asked for (or
    ``auto``) and on PATH, else the built-in simulator's.  Returns the two
    paths."""
    r1 = prefix + "_R1.fastq.gz"
    r2 = prefix + "_R2.fastq.gz"
    if simulator in ("auto", "art") and shutil.which("art_illumina"):
        cmd = (
            f"art_illumina -ss HS25 -i {genome_path} -p -l {read_length} "
            f"-f {coverage} -m 400 -s 10 -o {prefix}_art"
        )
        subprocess.run(cmd, shell=True, check=True)
        for src, dst in [(f"{prefix}_art1.fq", r1), (f"{prefix}_art2.fq", r2)]:
            with open(src, "rb") as fi, gzip.open(dst, "ab") as fo:
                shutil.copyfileobj(fi, fo)
            os.remove(src)
        return r1, r2
    for name, seq in read_fasta(genome_path):
        simulate_reads_builtin(
            seq, r1, r2, coverage, read_length, error_rate, rng, name=name
        )
    return r1, r2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", nargs="+", required=True,
                    help="reference genome fasta files to draw from")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--n-samples", type=int, default=4)
    ap.add_argument("--dist", type=int, default=10,
                    help="SNP distance between transmission-pair genomes")
    ap.add_argument("--coverage", type=float, default=20.0)
    ap.add_argument("--read-length", type=int, default=150)
    ap.add_argument("--error-rate", type=float, default=0.001)
    ap.add_argument("--n-strains", type=int, default=1,
                    help="genomes mixed per sample (metagenomic mode if >1)")
    ap.add_argument("--dirichlet-alpha", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulator", choices=["auto", "art", "builtin"],
                    default="auto")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.outdir, exist_ok=True)

    genomes = {}
    for path in args.genomes:
        for name, seq in read_fasta(path):
            genomes[name] = seq
    names = list(genomes)

    # transmission genome: pair of mutated copies shared by samples 0 and 1
    trans_name = names[rng.integers(0, len(names))]
    copy_a, copy_b, true_d = generate_genome_pair(
        genomes[trans_name], args.dist, rng
    )

    rows = []
    input_rows = []
    for s in range(args.n_samples):
        sdir = os.path.join(args.outdir, f"sample{s}")
        os.makedirs(sdir, exist_ok=True)
        # sample 0 carries copy A, sample 1 carries copy B (the true pair);
        # other samples carry random genomes only
        members = []
        if s == 0:
            members.append((trans_name + "_copyA", copy_a))
        elif s == 1:
            members.append((trans_name + "_copyB", copy_b))
        extra = max(0, args.n_strains - len(members))
        for name in rng.choice(names, size=extra, replace=False):
            members.append((name, genomes[name]))

        props = rng.dirichlet([args.dirichlet_alpha] * len(members))
        prefix = os.path.join(sdir, f"sample{s}")
        for (name, seq), p in zip(members, props):
            gpath = prefix + "_" + name + ".fasta"
            write_fasta(gpath, [(name, seq)])
            simulate_reads(
                gpath, prefix, args.coverage * p * len(members),
                args.read_length, args.error_rate, rng, args.simulator,
            )
            rows.append([f"sample{s}", name, f"{p:.6f}"])
        input_rows.append([f"sample{s}", prefix + "_R1.fastq.gz", prefix + "_R2.fastq.gz"])

    with open(os.path.join(args.outdir, "_dist_props.csv"), "w") as fh:
        fh.write("sample,genome,proportion\n")
        for r in rows:
            fh.write(",".join(r) + "\n")
        fh.write(f"# true transmission pair: sample0,sample1,{true_d}\n")

    with open(os.path.join(args.outdir, "input_data.tsv"), "w") as fh:
        fh.write("prefix\tr1\tr2\n")
        for r in input_rows:
            fh.write("\t".join(r) + "\n")

    print(f"simulated {args.n_samples} samples; true pair distance {true_d}")
    print(f"truth table: {os.path.join(args.outdir, '_dist_props.csv')}")


if __name__ == "__main__":
    main()
