"""The port's mesh planner and mesh rules (parallel/mesh.py,
parallel/multihost.py, ``RingCoo.fits``) against tracs_tpu's, and both mesh
engines over a 1 x 1 mesh in a gloo world of one, in this process: the
counterpart of tests/test_mesh_auto.py."""

import gzip

import numpy as np
import pytest
import torch.distributed as dist

from tracs_tpu_torch.ops.packing import pack_sequences as port_pack
from tracs_tpu_torch.ops.pairsnp import pairsnp_stream as port_stream
from tracs_tpu_torch.parallel import allpairs as port_ap
from tracs_tpu_torch.parallel import mesh as port_mesh
from tracs_tpu_torch.parallel import multihost
from tracs_tpu_torch.runtime import profiling
from tracs_tpu_torch.stages.distance import _peek_fasta_dims as port_peek

jax = pytest.importorskip("jax")

import tracs_tpu.parallel.allpairs as jax_ap  # noqa: E402
from tracs_tpu.ops.packing import pack_sequences as jax_pack  # noqa: E402
from tracs_tpu.ops.pairsnp import pairsnp_stream as jax_stream  # noqa: E402
from tracs_tpu.ops.pairsnp import snp_distance_dense as jax_dense  # noqa: E402
from tracs_tpu.parallel.mesh import best_mesh_shape as jax_best  # noqa: E402
from tracs_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from tracs_tpu.stages.distance import _peek_fasta_dims as jax_peek  # noqa: E402

MB_WORDS = 31250  # 1 Mb genome in packed words
SAMPLES = (1, 2, 4, 7, 13, 100, 512, 2048, 5000, 10000, 40000, 300000)
WORDS = (None, 1, 8, 16, 400, MB_WORDS, 4 * MB_WORDS)
SWEEP_COUNTERS = ("sweep.runs", "sweep.survivors", "sweep.copied_bytes")


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 5, 6, 8])
def test_best_mesh_shape_matches_reference(n_dev):
    assert port_mesh.best_mesh_shape(n_dev) == jax_best(n_dev)
    for n in SAMPLES:
        for w in WORDS:
            got = port_mesh.best_mesh_shape(n_dev, n_samples=n, n_words=w)
            assert got == jax_best(n_dev, n_samples=n, n_words=w), (n, w)
            dp, sp = got
            assert dp * sp == n_dev
            if w is not None:
                assert sp <= max(1, w // 8)


def test_shape_policy_grid():
    """The cases of tests/test_mesh_auto.py::test_shape_policy_grid and
    test_shape_respects_ring_budget, on the port's planner."""
    best = port_mesh.best_mesh_shape
    assert best(8, n_samples=10000, n_words=MB_WORDS) == (8, 1)
    assert best(8, n_samples=2048, n_words=MB_WORDS) == (4, 2)
    assert best(8, n_samples=512, n_words=MB_WORDS) == (1, 8)
    assert best(8, n_samples=4, n_words=16) == (4, 2)
    assert best(8) == (8, 1)
    assert best(1, n_samples=5, n_words=10) == (1, 1)
    assert best(8, n_samples=300000, n_words=MB_WORDS) == (8, 1)
    dp, _ = best(8, n_samples=40000, n_words=MB_WORDS)
    assert 16 * 40000 * (-(-40000 // dp)) <= 4 << 30


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (3, 2), (8, 1)])
def test_ring_fits_matches_reference(shape, monkeypatch):
    """RingCoo.fits and operand_bytes with tracs_tpu's arithmetic on the CPU,
    at its budgets and at budgets patched low (as
    tests/test_mesh_auto.py::test_ring_fits_is_length_aware does).  The
    stripes are the port's own figure (its extraction's output is not
    tracs_tpu's four stripes), so tracs_tpu's rule is run on that figure."""
    dp, sp = shape
    jmesh = jax_make_mesh(dp, sp, devices=jax.devices()[: dp * sp])
    monkeypatch.setattr(jax_ap.RingCoo, "stripe_bytes",
                        staticmethod(lambda n, mesh: port_ap.RingCoo.stripe_bytes(n, shape)))

    def compare():
        for n in SAMPLES:
            for w in WORDS:
                if w is not None:
                    assert (port_ap.RingCoo.operand_bytes(n, shape, w)
                            == jax_ap.RingCoo.operand_bytes(n, jmesh, w))
                assert (port_ap.RingCoo.fits(n, shape, n_words=w)
                        == jax_ap.RingCoo.fits(n, jmesh, n_words=w)), (n, w)

    compare()
    monkeypatch.setattr(port_ap, "_DEVICE_HBM_BYTES", 1 << 20)
    monkeypatch.setattr(jax_ap, "_DEVICE_HBM_BYTES", 1 << 20)
    monkeypatch.setattr(port_mesh, "RING_STRIPE_BYTES", 1 << 30)
    monkeypatch.setattr(jax_ap, "_RING_STRIPE_BYTES", 1 << 30)
    compare()
    monkeypatch.setattr(port_ap, "_CHUNK_BYTES_BUDGET", 1 << 16)
    monkeypatch.setattr("tracs_tpu.ops.pairsnp._CHUNK_BYTES_BUDGET", 1 << 16)
    compare()
    assert port_ap.RingCoo.fits(64, (2, 1), n_words=64)
    assert not port_ap.RingCoo.fits(64, (2, 1), n_words=10_000)


@pytest.mark.parametrize("n", [1, 7, 13, 100, 513])
@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_ring_stripe_bytes_counts_the_ports_peak(dp, n):
    """RingCoo.stripe_bytes: the two int32 gram rows of a stripe, [B, dp B],
    beside the larger of the extraction's 16-byte rows for every pair of the
    triangle a rank's stripe holds, counted pair by pair here, over the
    ranks, and a ring step's [B, B] int32 blocks (3, or 6 at dp >= 3)."""
    B = -(-n // dp)
    i, j = np.meshgrid(np.arange(dp * B), np.arange(n), indexing="ij")
    in_range = (j > i).sum(axis=1)
    most = max(int(in_range[r * B:(r + 1) * B].sum()) for r in range(dp))
    step = (6 if dp >= 3 else 3) * B * B * 4
    assert port_ap.RingCoo.stripe_bytes(n, (dp, 1)) == 8 * B * dp * B + max(16 * most, step)
    assert port_ap.RingCoo.stripe_bytes(n, (dp, 2)) == port_ap.RingCoo.stripe_bytes(n, (dp, 1))


@pytest.mark.parametrize("spec", [None, "off", "OFF", "auto", " auto ", "global", "1x1"])
def test_resolve_mesh_one_device(spec):
    """Without a process group every spec but a shape of more than one rank
    means one device: auto is this process's card, global a world of one."""
    assert not dist.is_initialized()
    assert port_mesh.resolve_mesh(spec, n_samples=100, n_words=100) is None


@pytest.mark.parametrize("spec,dp,sp", [("2x1", 2, 1), ("1x2", 1, 2), ("4x2", 4, 2)])
def test_resolve_mesh_shape_needs_its_world(spec, dp, sp):
    with pytest.raises(ValueError, match=f"mesh {dp}x{sp} needs {dp * sp} processes, "
                                         "the world has 1"):
        port_mesh.resolve_mesh(spec)


@pytest.mark.parametrize("spec", ["2by2", "x", "4x2x1", "ring"])
def test_resolve_mesh_refuses_a_bad_spec(spec):
    with pytest.raises(ValueError, match="invalid mesh spec"):
        port_mesh.resolve_mesh(spec)


@pytest.mark.parametrize("coordinator,n,pid", [(None, 4, 0), ("localhost:1", None, 0),
                                               ("localhost:1", 1, 0), ("localhost:1", 0, 0)])
def test_initialize_is_a_no_op_for_one_process(coordinator, n, pid):
    assert multihost.initialize(coordinator, n, pid, device="cpu") is False
    assert not dist.is_initialized()


def test_peek_fasta_dims_matches_reference(tmp_path):
    plain = tmp_path / "a.fasta"
    plain.write_text(">s0\n" + "ACGT" * 25 + "\n>s1\n" + "ACGT" * 25 + "\n")
    gz = tmp_path / "b.fasta.gz"
    with gzip.open(gz, "wt") as fh:
        for i in range(37):
            fh.write(f">s{i}\n" + "A" * 65 + "\n")
    one = tmp_path / "c.fasta"
    one.write_text(">only\nACGT\nACGTAC\n")
    for path, want in ((plain, (2, 4)), (gz, (37, 3)), (one, (1, 1)),
                       (tmp_path / "missing.fasta", (None, None))):
        assert port_peek(str(path)) == jax_peek(str(path)) == want


def test_sharded_snp_distance_without_a_group_is_one_device(rng):
    """No process group: the world is this process, and the dense matrices
    come from the one-device sweep, equal to tracs_tpu's."""
    assert not dist.is_initialized()
    seqs = ["".join(rng.choice(np.array(list("ACGTNRY")), size=300)) for _ in range(9)]
    D, NN = port_ap.sharded_snp_distance(port_pack(seqs), device="cpu")
    D0, NN0 = jax_dense(jax_pack(seqs))
    assert np.array_equal(D, D0) and np.array_equal(NN, NN0)


def _collect(stream):
    out = [[], [], [], [], []]
    for _r0, _r1, _nm, r, c, d, f, nn in stream:
        for k, col in enumerate((r, c, d, f, nn)):
            out[k] += [int(x) for x in col]
    return out


def test_both_engines_on_a_one_by_one_mesh(tmp_path, rng):
    """A gloo world of one in this process: ``pairsnp_stream`` over a 1 x 1
    mesh runs the ring from row 0 and the block sweep from row 6 (the mesh
    phase of chip_smoke.py runs the same on nccl), and both yield
    tracs_tpu's arrays; ``initialize`` leaves a group that is up alone."""
    chars = np.array(list("ACGTMRWSYKVHDBN"))
    seqs = ["".join(rng.choice(chars, size=350)) for _ in range(11)]
    made = []
    real = {cls: cls.__init__ for cls in (port_ap.RingCoo, port_ap.ShardedSweep)}
    multihost.init_group(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        assert multihost.initialize("localhost:1", 2, 0, device="cpu") is False
        mesh = port_mesh.make_mesh(1, 1)
        assert tuple(multihost.global_mesh().shape) == (1, 1)
        for cls in real:
            def init(self, *a, _cls=cls, **k):
                made.append(_cls.__name__)
                real[_cls](self, *a, **k)
            cls.__init__ = init
        for start in (0, 6):
            want = _collect(jax_stream([jax_pack(seqs)], dist=150, row_block=3,
                                       start_row=start))
            before = [profiling.counter(k) for k in SWEEP_COUNTERS]
            got = _collect(port_stream([port_pack(seqs)], dist=150, row_block=3,
                                       start_row=start, device="cpu", mesh=mesh))
            assert got == want
            # one run a call; the one rank's copy holds every survivor
            runs, survivors, copied = (profiling.counter(k) - b
                                       for k, b in zip(SWEEP_COUNTERS, before))
            assert runs == 1 and copied == 16 * survivors == 16 * len(got[0]) > 0
        assert made == ["RingCoo", "ShardedSweep"]
        # mesh None is every rank of the world: here the 1 x 1 ring
        D, NN = port_ap.sharded_snp_distance(port_pack(seqs), device="cpu")
        D0, NN0 = jax_dense(jax_pack(seqs))
        assert np.array_equal(D, D0) and np.array_equal(NN, NN0)
    finally:
        for cls, init in real.items():
            cls.__init__ = init
        dist.destroy_process_group()
