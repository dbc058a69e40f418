"""One rank of a multi-process run of tracs_tpu_torch on the CPU (gloo), for
tests/test_torch_sharded.py and tests/test_torch_multihost.py.

    python tests/torch_mesh_worker.py cases  INPUTS OUTDIR DP SP URL RANK
    python tests/torch_mesh_worker.py pipe   INPUTS OUTDIR NPROC URL RANK

``cases``: a gloo world of DP * SP ranks (``multihost.initialize`` at the
file:// store URL), a DP x SP mesh, and every case on it, each rank saving
its results as ``OUTDIR/<case>.<rank>.npz`` for the parent test to hold
against tracs_tpu.  ``pipe``: the ``pipe`` CLI with the launch flags, the
aligner stood in for by a copy of the pileup that the parent staged in
INPUTS/pileups; each rank lists the samples it aligned.  Imports neither jax
nor tracs_tpu, so a rank starts in seconds.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TIMEOUT = timedelta(seconds=90)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch_world(argvs, logdir, timeout=120):
    """Run one process per argument list (``python <argv>``) from the repo's
    root, each with its output in ``logdir/rank<r>.log``; raises unless all
    exit 0 within ``timeout`` seconds in all, and kills any still running."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    logs = [open(os.path.join(logdir, f"rank{r}.log"), "w") for r in range(len(argvs))]
    procs = [subprocess.Popen([sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
                              cwd=REPO, env=env) for argv, log in zip(argvs, logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(logdir, f"rank{r}.log")) as fh:
                tail = fh.read()[-4000:]
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{tail}")


def _save(outdir, case, rank, **arrays):
    np.savez(os.path.join(outdir, f"{case}.{rank}.npz"), **arrays)


def _lists(res):
    """pairsnp's six columns as arrays (names as a string array)."""
    rows, cols, d, names, filt, nn = res
    return dict(rows=np.asarray(rows, dtype=np.int64), cols=np.asarray(cols, dtype=np.int64),
                d=np.asarray(d, dtype=np.int64), names=np.asarray(names),
                filt=np.asarray(filt, dtype=np.int64), nn=np.asarray(nn, dtype=np.int64))


def run_cases(inputs, outdir, dp, sp, url, rank):
    from tracs_tpu_torch.ops.packing import pack_fasta
    from tracs_tpu_torch.ops.pairsnp import pairsnp, pairsnp_stream
    from tracs_tpu_torch.parallel import allpairs, mesh as mesh_mod, multihost
    from tracs_tpu_torch.stages import distance

    assert multihost.initialize(url, dp * sp, rank, device="cpu", timeout=TIMEOUT) is True
    assert multihost.initialize(url, dp * sp, rank, device="cpu") is False  # already up
    mesh = mesh_mod.make_mesh(dp, sp)
    assert tuple(mesh.shape) == (dp, sp)
    if sp == 1:
        assert tuple(multihost.global_mesh().shape) == (dp, 1)

    def f(name):
        return os.path.join(inputs, name)

    engines = []
    real_ring, real_sweep = allpairs.RingCoo.__init__, allpairs.ShardedSweep.__init__

    def spy(kind, real):
        def init(self, *a, **k):
            engines.append(kind)
            real(self, *a, **k)
        return init

    allpairs.RingCoo.__init__ = spy("ring", real_ring)
    allpairs.ShardedSweep.__init__ = spy("sweep", real_sweep)

    D, NN = allpairs.sharded_snp_distance(pack_fasta(f("r13.fasta")), mesh, device="cpu")
    _save(outdir, "dense", rank, D=D, NN=NN)
    D, NN = allpairs.sharded_snp_distance(pack_fasta(f("backbone.fasta")), mesh, device="cpu",
                                          compact=True)
    _save(outdir, "dense_compact", rank, D=D, NN=NN)
    D, NN = allpairs.sharded_snp_distance(pack_fasta(f("tiny3.fasta")), mesh, device="cpu")
    _save(outdir, "dense_tiny", rank, D=D, NN=NN)

    def stream(case, fastas, **kw):
        del engines[:]
        res = pairsnp([pack_fasta(f(x)) for x in fastas], device="cpu", mesh=mesh, **kw)
        _save(outdir, case, rank, engines=np.asarray(engines), **_lists(res))

    stream("triangle", ["r13.fasta"], dist=120, row_block=5)
    stream("rectangle", ["q6.fasta", "db9.fasta"], dist=10**9, row_block=4)
    stream("filter", ["acgt9.fasta"], dist=10**9, filter=True, row_block=3)

    del engines[:]
    blocks = list(pairsnp_stream([pack_fasta(f("r11.fasta"))], dist=150, row_block=3,
                                 start_row=6, device="cpu", mesh=mesh))
    _save(outdir, "resume", rank, engines=np.asarray(engines),
          **{k: np.concatenate([b[i] for b in blocks]) for i, k in
             ((3, "rows"), (4, "cols"), (5, "d"), (6, "filt"), (7, "nn"))},
          spans=np.asarray([b[:2] for b in blocks]))

    budget = mesh_mod.RING_STRIPE_BYTES
    mesh_mod.RING_STRIPE_BYTES = 1  # no ring fits: the block sweep takes over
    try:
        stream("over_budget", ["r13.fasta"], dist=120, row_block=5)
    finally:
        mesh_mod.RING_STRIPE_BYTES = budget

    distance.main(["--msa", f("toy.fasta"), "-o", os.path.join(outdir, "dist.csv"), "--filter",
                   "--mesh", f"{dp}x{sp}", "--row-block", "4", "--device", "cpu"])
    with open(os.path.join(outdir, f"done.{rank}"), "w") as fh:
        json.dump({"collective_bytes": mesh_mod.COLLECTIVE_BYTES}, fh)


def run_pipe(inputs, outdir, nproc, url, rank):
    from tracs_tpu_torch import cli
    from tracs_tpu_torch.stages import align

    staged = os.path.join(inputs, "pileups")
    aligned = []

    def stand_in(reference, out, prefix, r1, r2=None, **kw):
        sample = os.path.basename(prefix).split("_ref_")[0]
        aligned.append(sample)
        shutil.copy(os.path.join(staged, f"{sample}.txt.gz"), prefix + "_pileup.txt.gz")

    align.align_and_pileup = stand_in
    align.run_gather = lambda **kw: ["REF1"]
    cli.main(["pipe", "-i", os.path.join(inputs, "input.tsv"), "--database",
              os.path.join(inputs, "db.zip"), "-o", os.path.join(outdir, "pipe_out"),
              "--min-cov", "2", "--device", "cpu", "--coordinator", url,
              "--num-processes", str(nproc), "--process-id", str(rank)])
    tail = os.path.exists(os.path.join(outdir, "pipe_out", "transmission_clusters.csv"))
    with open(os.path.join(outdir, f"ingest.{rank}.json"), "w") as fh:
        json.dump({"aligned": aligned, "outputs_there_at_exit": tail}, fh)


if __name__ == "__main__":
    torch.set_num_threads(1)  # a world of 8 ranks shares the machine with other tests
    mode, inputs, outdir = sys.argv[1:4]
    if mode == "cases":
        dp, sp, url, rank = sys.argv[4:8]
        run_cases(inputs, outdir, int(dp), int(sp), url, int(rank))
    elif mode == "pipe":
        nproc, url, rank = sys.argv[4:7]
        run_pipe(inputs, outdir, int(nproc), url, int(rank))
    else:
        raise SystemExit(f"unknown mode {mode!r}")
