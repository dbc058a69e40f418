"""The port's CLI as several real processes on the CPU (gloo), wired by
``--coordinator``/``--num-processes``/``--process-id``, held against
tracs_tpu's single-process run: the counterpart of tests/test_multihost.py.

``distance``: every rank runs the stage over the mesh and writes the bytes
of ``tracs_tpu distance --mesh off`` (rank 0 ``dist.csv``, rank r
``dist.csv.proc<r>``).  ``pipe``: rank r aligns the samples i with
i % world == r, all meet at a barrier, rank 0 runs combine, distance and
cluster, and no rank leaves before the outputs exist; the outputs are those
of tracs_tpu's one-process pipe.  Each world fails after 120 s."""

import json
import os

import numpy as np
import pytest

from torch_mesh_worker import launch_world

jax = pytest.importorskip("jax")

from test_torch_align_pipe import (  # noqa: E402
    _pipe_inputs,
    assert_same_pipe_outputs,
    make_sample,
    patch_both,
    ref_genome,
    stand_in_aligner,
    write_fake_pileup,
)
from tracs_tpu import cli as jax_cli  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")


def _launch_flags(url, nproc, rank):
    return ["--coordinator", url, "--num-processes", str(nproc), "--process-id", str(rank)]


@pytest.mark.parametrize("nproc,flags,shape", [
    (2, ["--mesh", "global"], "{'dp': 2, 'sp': 1}"),
    (4, ["--mesh", "global", "--filter"], "{'dp': 4, 'sp': 1}"),
    (4, ["--mesh", "2x2"], "{'dp': 2, 'sp': 2}"),
])
def test_distance_cli_on_several_processes(tmp_path, rng, nproc, flags, shape):
    chars = np.array(list("ACGTNRY"))
    msa = tmp_path / "mh.fasta"
    msa.write_text("".join(f">s{i}\n{''.join(rng.choice(chars, size=401))}\n"
                           for i in range(13)))
    extra = [f for f in flags if f == "--filter"]
    ref = tmp_path / "ref.csv"
    jax_cli.main(["distance", "--msa", str(msa), "-o", str(ref), "--mesh", "off",
                  "--row-block", "3", *extra])

    out = tmp_path / "out"
    out.mkdir()
    url = f"file://{tmp_path / 'store'}"
    launch_world([["-m", "tracs_tpu_torch", "distance", "--msa", str(msa),
                   "-o", str(out / "dist.csv"), "--row-block", "3", "--device", "cpu", *flags,
                   *_launch_flags(url, nproc, r)] for r in range(nproc)], str(tmp_path))
    want = ref.read_bytes()
    paths = [out / "dist.csv"] + [out / f"dist.csv.proc{r}" for r in range(1, nproc)]
    for path in paths:
        assert path.read_bytes() == want, path
    for r in range(nproc):  # the sweep ran on the mesh, not on each rank alone
        assert f"Running on a {shape} mesh" in (tmp_path / f"rank{r}.log").read_text()


@pytest.mark.parametrize("nproc", [2, 4])
def test_pipe_on_several_processes(tmp_path, monkeypatch, nproc):
    ref = ref_genome()
    samples = {"close1": make_sample(ref, [100, 200]), "close2": make_sample(ref, [100, 250]),
               "far1": make_sample(ref, list(range(500, 560)))}
    tsv, db = _pipe_inputs(tmp_path, ref, samples)
    os.mkdir(tmp_path / "pileups")
    for name, seq in samples.items():
        write_fake_pileup(tmp_path / "pileups" / f"{name}.txt.gz", ref, seq)

    patch_both(monkeypatch, stand_in_aligner(ref, samples), gather=["REF1"])
    jax_out = tmp_path / "jax_out"
    jax_cli.main(["pipe", "-i", tsv, "--database", db, "--min-cov", "2", "-o", str(jax_out),
                  "--mesh", "off"])

    url = f"file://{tmp_path / 'store'}"
    launch_world([[WORKER, "pipe", str(tmp_path), str(tmp_path), str(nproc), url, str(r)]
                  for r in range(nproc)], str(tmp_path))
    assert_same_pipe_outputs(tmp_path / "pipe_out", jax_out, samples)
    order = list(samples)  # the TSV's order
    for r in range(nproc):
        with open(tmp_path / f"ingest.{r}.json") as fh:
            rec = json.load(fh)
        assert rec["aligned"] == [s for i, s in enumerate(order) if i % nproc == r]
        assert rec["outputs_there_at_exit"]
