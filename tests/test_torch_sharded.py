"""The port's mesh engines (parallel/allpairs.py) on real multi-process gloo
worlds on the CPU, held against tracs_tpu's one-device results in the same
run: the counterpart of tests/test_sharded.py.

Each mesh shape's world is spawned once (a module-scoped fixture): its ranks
run every case (tests/torch_mesh_worker.py) and save what each returned; the
tests then hold every rank's arrays against tracs_tpu's exactly: D, NN, the
COO emission order, the filtered distance, and the ``distance`` CSV bytes of
every rank (``dist.csv`` and each ``.procN``).  A world that hangs fails
after 120 s.

Not ported from tests/test_sharded.py, because they test TPU machinery that
the port leaves out (ROADMAP.md): ``test_ring_and_stream_with_forced_chunking``
and ``test_plan_chunks_budget_accounting`` (``plan_chunks``),
``test_ring_capacity_overflow_reextracts``, ``test_ring_dense_stripe_reextracts``
(the ring's capacity and its re-extract), ``test_survivor_density_hint_feeds_next_run``
(the density hint) and ``test_plan_capacity_sizing`` (``plan_capacity``).
"""

import os

import numpy as np
import pytest

from torch_mesh_worker import launch_world

jax = pytest.importorskip("jax")

from tracs_tpu import cli as jax_cli  # noqa: E402
from tracs_tpu.ops.packing import pack_fasta as jax_pack  # noqa: E402
from tracs_tpu.ops.pairsnp import pairsnp as jax_pairsnp  # noqa: E402
from tracs_tpu.ops.pairsnp import pairsnp_stream as jax_stream  # noqa: E402
from tracs_tpu.ops.pairsnp import snp_distance_dense as jax_dense  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
SHAPES = [(8, 1), (4, 2), (2, 4), (3, 2), (5, 1)]
IUPAC = "ACGTMRWSYKVHDBN"


def _write(path, seqs):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i}\n{s}\n")


def _random(rng, n, L, chars=IUPAC):
    arr = np.array(list(chars))
    return ["".join(rng.choice(arr, size=L)) for _ in range(n)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_inputs")
    rng = np.random.default_rng(12345)
    _write(d / "r13.fasta", _random(rng, 13, 401))
    base = rng.choice(np.array(list("ACGT")), size=500)
    backbone = []
    for _ in range(11):
        s = base.copy()
        idx = rng.choice(500, size=12, replace=False)
        s[idx] = rng.choice(np.array(list("ACGTN")), size=12)
        backbone.append("".join(s))
    _write(d / "backbone.fasta", backbone)
    _write(d / "tiny3.fasta", _random(rng, 3, 100))
    _write(d / "q6.fasta", _random(rng, 6, 300))
    _write(d / "db9.fasta", _random(rng, 9, 300))
    _write(d / "acgt9.fasta", _random(rng, 9, 500, "ACGT"))
    _write(d / "r11.fasta", _random(rng, 11, 350))
    _write(d / "toy.fasta", _random(rng, 11, 257))
    return d


@pytest.fixture(scope="module", params=SHAPES, ids=[f"{dp}x{sp}" for dp, sp in SHAPES])
def world(request, inputs, tmp_path_factory):
    """(n ranks, the directory of their results) of one gloo world."""
    dp, sp = request.param
    out = tmp_path_factory.mktemp(f"mesh_{dp}x{sp}")
    url = f"file://{out / 'store'}"
    launch_world([[WORKER, "cases", str(inputs), str(out), str(dp), str(sp), url, str(r)]
                  for r in range(dp * sp)], str(out), timeout=120)
    return dp * sp, out


def _ranks(world, case):
    n, out = world
    return [np.load(out / f"{case}.{r}.npz") for r in range(n)]


def _path(inputs, name):
    return str(inputs / name)


def _assert_lists(got, want):
    rows, cols, d, names, filt, nn = want
    assert list(got["names"]) == list(names)
    for key, col in (("rows", rows), ("cols", cols), ("d", d), ("filt", filt), ("nn", nn)):
        assert got[key].tolist() == [int(x) for x in col], key


@pytest.mark.parametrize("case,fasta,kw", [
    ("dense", "r13.fasta", {}),
    ("dense_compact", "backbone.fasta", {}),
    ("dense_tiny", "tiny3.fasta", {}),  # fewer samples than dp ranks: padded stripes
])
def test_sharded_snp_distance_matches_reference(world, inputs, case, fasta, kw):
    D0, NN0 = jax_dense(jax_pack(_path(inputs, fasta)))
    for got in _ranks(world, case):
        assert np.array_equal(got["D"], D0)
        assert np.array_equal(got["NN"], NN0)


@pytest.mark.parametrize("case,fastas,kw,engine", [
    ("triangle", ["r13.fasta"], dict(dist=120, row_block=5), "ring"),
    ("rectangle", ["q6.fasta", "db9.fasta"], dict(dist=10**9), "sweep"),
    ("filter", ["acgt9.fasta"], dict(dist=10**9, filter=True), "ring"),
    # the ring's stripes over its budget: the block sweep, the same arrays
    ("over_budget", ["r13.fasta"], dict(dist=120, row_block=5), "sweep"),
])
def test_stream_on_mesh_matches_reference(world, inputs, case, fastas, kw, engine):
    want = jax_pairsnp([jax_pack(_path(inputs, f)) for f in fastas], **kw)
    for got in _ranks(world, case):
        assert got["engines"].tolist() == [engine]
        _assert_lists(got, want)


def test_stream_resume_mid_matrix(world, inputs):
    """start_row > 0 (the --resume route) runs the block sweep and yields
    tracs_tpu's tail block for block."""
    blocks = list(jax_stream([jax_pack(_path(inputs, "r11.fasta"))], dist=150, row_block=3,
                             start_row=6))
    for got in _ranks(world, "resume"):
        assert got["engines"].tolist() == ["sweep"]
        assert got["spans"].tolist() == [[b[0], b[1]] for b in blocks]
        for i, key in ((3, "rows"), (4, "cols"), (5, "d"), (6, "filt"), (7, "nn")):
            assert got[key].tolist() == np.concatenate([b[i] for b in blocks]).tolist(), key


def test_distance_csv_on_mesh_equals_reference(world, inputs, tmp_path):
    """``distance --filter --mesh DPxSP`` on every rank: dist.csv and each
    rank's .procN hold the bytes of ``tracs_tpu distance --mesh off``."""
    n, out = world
    ref = tmp_path / "ref.csv"
    jax_cli.main(["distance", "--msa", _path(inputs, "toy.fasta"), "-o", str(ref), "--filter",
                  "--mesh", "off", "--row-block", "4"])
    want = ref.read_bytes()
    assert len(want.splitlines()) == 1 + 11 * 10 // 2
    paths = [out / "dist.csv"] + [out / f"dist.csv.proc{r}" for r in range(1, n)]
    for path in paths:
        assert path.read_bytes() == want, path
    assert not (out / "dist.csv.cursor").exists()
