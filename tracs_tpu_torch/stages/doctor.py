"""``doctor`` stage: preflight of the external tools, the native library, the
card and the CUDA kernels (counterpart of tracs_tpu/stages/doctor.py).

* presence and version of every external tool a stage shells out to, from
  the same table the stages render their command lines from
  (io/external.py ``VERSION_PROBES`` / ``COMMANDS``);
* a live micro-pipeline on a built-in 2 kb synthetic genome: shred, align,
  pileup through the exact production command lines
  (io/external.py::align_and_pileup), then parse the pileup and check the
  consensus recovers the genome, so a flag incompatibility fails here, in
  seconds, with the offending command printed;
* the runtime (``check_runtime``, where tracs_tpu probes its JAX devices):
  the native host library builds, and the port's host code beside its
  kernels (``csrc/mism_plan.cpp``); the torch version and the CUDA it was
  built for; whether a card is visible, with its name and power limit as
  nvidia-smi reports them; nvcc's version; and whether every kernel source
  ``csrc/<name>.cu`` of ``runtime/build.py::KERNELS`` builds for sm_90a.

With ``--device cuda`` (the default, as for every stage that takes one) a
missing card, nvcc or kernel is a problem line that says it blocks the card
path.  ``--device cpu`` checks what a CPU run needs, and reports the card's
state without counting it.  Exit code 0 = everything needed for full
``pipe`` runs on the chosen device works; 1 = some capability is missing
(each line says which stages it blocks).
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from tracs_tpu_torch.io.external import COMMANDS
from tracs_tpu_torch.io.external import VERSION_PROBES as _TOOLS
from tracs_tpu_torch.utils import add_loglevel_arg, setup_logging

_OPTIONAL = {
    "art_illumina": "read simulation (scripts/tracs_sim.py --simulator art)",
    "badread": "read simulation (scripts/tracs_sim.py --simulator badread)",
}

_CARD_PATH = "blocks the card path (every --device cuda run, the default); --device cpu still works"


def doctor_parser(parser):
    parser.description = (
        "Checks that the external tools, native runtime, card and CUDA kernels "
        "needed by each stage are present and flag-compatible."
    )
    parser.add_argument(
        "--full", action="store_true",
        help="also run the live micro-pipeline through the real aligner "
             "command lines (default: run it whenever the alignment tools "
             "are present)",
    )
    parser.add_argument(
        "--device", dest="device", choices=["cuda", "cpu"], default="cuda",
        help="the device the checked runs will use (default: cuda): with cuda a "
             "missing card, nvcc or kernel build is a problem",
    )
    add_loglevel_arg(parser)
    parser.set_defaults(func=doctor)
    return parser


def _version_of(tool: str, version_cmd: str | None) -> str:
    if version_cmd is None:
        return "present"
    try:
        out = subprocess.run(
            version_cmd, shell=True, capture_output=True, text=True, timeout=30
        )
    except (OSError, subprocess.SubprocessError):
        return "present (version probe failed)"
    first = (out.stdout or out.stderr).strip().splitlines()
    return first[0][:79] if first else "present"


def check_tools() -> tuple[list[str], list[str]]:
    """(ok_lines, problem_lines) for the external tools."""
    ok, problems = [], []
    for tool, (version_cmd, needed_by) in _TOOLS.items():
        if shutil.which(tool):
            ok.append(f"{tool}: {_version_of(tool, version_cmd)}")
        else:
            problems.append(
                f"{tool}: NOT FOUND on PATH — blocks {needed_by}. The "
                f"packing/distance/cluster stages still work from "
                f"pre-computed pileups or MSAs."
            )
    for tool, needed_by in _OPTIONAL.items():
        if shutil.which(tool):
            ok.append(f"{tool}: {_version_of(tool, None)} (optional)")
        else:
            ok.append(f"{tool}: absent (optional — only {needed_by})")
    return ok, problems


def _write_micro_dataset(d: str) -> tuple[str, str]:
    """A 2 kb random genome and a shredded read set for the live probe."""
    from tracs_tpu_torch.io.external import generate_reads

    rng = random.Random(20240917)
    genome = "".join(rng.choice("ACGT") for _ in range(2000))
    ref = os.path.join(d, "ref.fasta")
    with open(ref, "w") as fh:
        fh.write(">doctor_ref\n" + genome + "\n")
    reads = os.path.join(d, "reads.fasta.gz")
    generate_reads(ref, reads, coverage=8, read_length=150)
    return ref, reads


def run_micro_pipeline() -> list[str]:
    """Drive the production align_and_pileup command contract end to end on
    a synthetic genome; returns problem lines (empty = pass)."""
    import numpy as np

    from tracs_tpu_torch.io.external import align_and_pileup
    from tracs_tpu_torch.io.pileup import parse_pileup

    with tempfile.TemporaryDirectory() as d:
        ref, reads = _write_micro_dataset(d)
        prefix = os.path.join(d, "probe")
        try:
            align_and_pileup(ref, d + os.sep, prefix, reads, n_cpu=1)
        except subprocess.CalledProcessError as e:
            return [f"pileup pipeline FAILED (flag drift?): {e.cmd!r} "
                    f"exited {e.returncode}"]
        except Exception as e:  # noqa: BLE001 — report, don't crash doctor
            return [f"pileup pipeline FAILED: {e}"]
        pile = prefix + "_pileup.txt.gz"
        if not os.path.exists(pile):
            return [f"pileup pipeline produced no output at {pile}"]
        counts = parse_pileup(pile, {"doctor_ref": 2000}, True)
        covered = (counts.sum(axis=1) > 0).mean()
        if covered < 0.5:
            return [f"pileup parsed but only {covered:.0%} of the genome is "
                    f"covered — check htsbox/samtools output formats"]
        # consensus must recover the reference at covered sites
        with open(ref) as fh:
            fh.readline()
            genome = np.frombuffer(fh.readline().strip().encode(), dtype="S1")
        idx = np.nonzero(counts.sum(axis=1) > 0)[0]
        call = np.array([b"A", b"C", b"G", b"T"])[counts[idx].argmax(axis=1)]
        mismatch = (call != genome[idx]).mean()
        if mismatch > 0.01:
            return [f"consensus mismatches the reference at {mismatch:.1%} "
                    f"of covered sites — pileup column semantics drifted"]
    return []


def _card_line() -> tuple[bool, str]:
    """(a card is visible, its line)."""
    import torch

    if not torch.cuda.is_available():
        why = ("torch was built without CUDA" if torch.version.cuda is None
               else "torch.cuda.is_available() is False")
        return False, f"card: none visible ({why})"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"{torch.cuda.get_device_name(0)} (nvidia-smi failed: {e})"
    return True, f"card: {smi} ({torch.cuda.device_count()} visible)"


def _nvcc_line() -> tuple[bool, str]:
    from tracs_tpu_torch.runtime.build import BuildError, nvcc_path

    try:
        nvcc = nvcc_path()
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (BuildError, OSError, subprocess.SubprocessError) as e:
        return False, f"nvcc: {e}"
    release = [ln for ln in out.splitlines() if "release" in ln]
    return True, f"nvcc: {nvcc}, {(release or ['version unknown'])[-1].strip()}"


def _kernel_lines(have_nvcc: bool) -> tuple[list[str], list[str]]:
    """(built, not built) lines of the kernel sources, built in parallel."""
    from tracs_tpu_torch.runtime.build import KERNELS, BuildError, build_cuda_library

    if not have_nvcc:
        return [], [f"kernel {name}.cu: not built (no nvcc)" for name in KERNELS]

    def build(name):
        try:
            path, _ = build_cuda_library(name)
            return True, f"kernel {name}.cu: builds for sm_90a ({os.path.basename(path)})"
        except BuildError as e:
            return False, f"kernel {name}.cu: build FAILED: {str(e).splitlines()[0]}"

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        results = list(pool.map(build, KERNELS))
    return ([line for good, line in results if good],
            [line for good, line in results if not good])


def check_runtime(device: str = "cuda") -> tuple[list[str], list[str]]:
    """(ok_lines, problem_lines) of the runtime.  With ``device`` cuda a
    missing card, nvcc or kernel build is a problem line naming what it
    blocks; with cpu the card's state is reported as an ok line and the
    kernels are not built."""
    import torch

    from tracs_tpu_torch.runtime.build import BuildError, load_host_library
    from tracs_tpu_torch.runtime.native import get_lib

    ok, problems = [], []
    if get_lib() is not None:
        ok.append("native host library: built and loadable")
    else:
        problems.append(
            "native host library failed to build (g++ or zlib missing?) — "
            "numpy fallbacks keep everything working, slower ingest"
        )
    ok.append(f"torch {torch.__version__}, built for CUDA {torch.version.cuda or 'none'}")
    try:
        load_host_library("mism_plan")
        ok.append("host code mism_plan.cpp (the tiled mismatch-position kernel's tile plan): "
                  "built and loadable")
    except (BuildError, OSError) as e:
        problems.append(f"host code mism_plan.cpp failed to build ({str(e).splitlines()[0]}) — "
                        f"the card's --filter path needs it")
    card, card_line = _card_line()
    nvcc, nvcc_line = _nvcc_line()
    if device == "cpu":
        ok.append(f"{card_line} — not needed with --device cpu")
        ok.append(f"{nvcc_line} — not needed with --device cpu")
        return ok, problems
    (ok if card else problems).append(card_line if card else f"{card_line} — {_CARD_PATH}")
    (ok if nvcc else problems).append(nvcc_line if nvcc else f"{nvcc_line} — {_CARD_PATH}")
    built, failed = _kernel_lines(nvcc)
    ok += built
    problems += [f"{line} — {_CARD_PATH}" for line in failed]
    return ok, problems


def doctor(args) -> int:
    setup_logging(getattr(args, "loglevel", "INFO"))
    ok, problems = check_tools()
    ok.append(
        "command contracts: "
        + ", ".join(sorted(COMMANDS))
        + " (io/external.py COMMANDS — templates shared by stages and this probe)"
    )
    ok2, problems2 = check_runtime(getattr(args, "device", "cuda"))
    ok += ok2
    problems += problems2

    aligner_ready = all(
        shutil.which(t) for t in ("minimap2", "samtools", "htsbox", "gzip")
    )
    if aligner_ready or getattr(args, "full", False):
        logging.info("running live pileup micro-pipeline...")
        micro = run_micro_pipeline()
        if micro:
            problems += micro
        else:
            ok.append("live pileup micro-pipeline: consensus recovered OK")
    else:
        ok.append("live pileup micro-pipeline: skipped (aligner tools absent)")

    for line in ok:
        print("  ok  " + line)
    for line in problems:
        print("FAIL  " + line)
    if problems:
        print(f"\n{len(problems)} problem(s) found.")
        return 1
    print("\nAll checks passed.")
    return 0


def main(argv=None):
    parser = doctor_parser(argparse.ArgumentParser())
    args = parser.parse_args(argv)
    sys.exit(args.func(args))


if __name__ == "__main__":
    main()
