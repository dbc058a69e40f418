"""The port's headline bench (``tracs_tpu_torch.experiments.bench``) on the
CPU at small sizes, against the JAX package's ``bench.py``: every engine's
survivors equal ``tracs_tpu``'s ``pairsnp_stream`` on ``bench.make_clustered``
block for block (exact integers); the JSON line starts with bench.py's seven
keys in bench.py's order; the pair count under ``mfu`` equals what the gram
kernels were handed; the layout stays resident through the timed sweeps;
``bench_cpu_reference``'s inner loop equals ``snp_distance_dense``'s D and NN;
``--device cuda`` without a card exits 1."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tracs_tpu_torch.experiments import bench as port_bench
from tracs_tpu_torch.experiments.workload import make_clustered
from tracs_tpu_torch.ops import pairsnp as port_pairsnp
from tracs_tpu_torch.runtime.device import DeviceUnavailableError

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (n, L, row block): ragged blocks, a block wider than n, and n=96 x 20 kb at rb=32
CASES = [(96, 20_000, 32), (70, 5_000, 16), (40, 3_000, 64)]
IUPAC = np.array(list("ACGTMRWSYKVHDBN-"))


@pytest.fixture(scope="module")
def ref_bench():
    """The JAX package's bench.py, loaded from the repo root."""
    spec = importlib.util.spec_from_file_location("bench_reference",
                                                  os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_blocks(ref_bench):
    """{case: (the reference's planes, its pairsnp_stream blocks)}, each made once."""
    from tracs_tpu.ops.pairsnp import pairsnp_stream

    out = {}
    for n, L, rb in CASES:
        packed = ref_bench.make_clustered(n, L, cluster_size=port_bench.cluster_size(n))
        blocks = [(r0, r1, rows, cols, d, nn) for r0, r1, _names, rows, cols, d, _f, nn
                  in pairsnp_stream([packed], dist=200, compact=False, row_block=rb)]
        out[(n, L, rb)] = (np.asarray(packed.planes), blocks)
    return out


def _headline(n, L):
    return make_clustered(n, L, cluster_size=port_bench.cluster_size(n))


@pytest.mark.parametrize("method", ["split", "popcount", "mxu"])
@pytest.mark.parametrize("case", CASES, ids=[f"n{n}-L{L}-rb{rb}" for n, L, rb in CASES])
def test_bench_survivors_match_reference(ref_blocks, case, method):
    n, L, rb = case
    planes, want = ref_blocks[case]
    packed = _headline(n, L)
    assert np.array_equal(packed.planes, planes)
    got = port_bench.sweep(packed, row_block=rb, method=method, device="cpu")
    assert len(got) == len(want) == -(-n // rb)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        for x, y in zip(g[2:], w[2:]):
            assert np.array_equal(np.asarray(x, dtype=np.int64), np.asarray(y, dtype=np.int64))
    survivors = sum(len(b[2]) for b in want)
    sizes = np.bincount(np.arange(n) // port_bench.cluster_size(n))
    assert survivors == int((sizes * (sizes - 1) // 2).sum()) > 0


def test_json_line_keys_follow_bench_py(ref_bench, ref_blocks, monkeypatch, capsys):
    """The line's first seven keys are bench.py's, in its order (bench.py's
    own line, printed with its timing functions stood in for), then the
    port's four."""
    monkeypatch.setattr(ref_bench, "bench_tpu", lambda n, L: (1.0, 0.5, 0.25, 0.125))
    monkeypatch.setattr(ref_bench, "bench_cpu_reference", lambda n, L: 2.0)
    ref_bench.main()
    want = list(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert len(want) == 7
    port_bench.main(["--device", "cpu", "--n", "96", "--length", "20000", "--row-block", "32"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert list(line) == want + ["method", "peak_tops", "survivors", "device"]
    assert line["metric"] == port_bench.METRIC and line["unit"] == "pairs/s"
    assert line["survivors"] == sum(len(b[2]) for b in ref_blocks[(96, 20_000, 32)][1])
    assert line["method"] == "split" and line["device"] == "cpu" and line["peak_tops"] == 15832
    assert line["mfu"] is None  # a share of the card's peak: none on the CPU
    assert line["sweep_s_min"] <= line["sweep_s_median"]
    assert line["value"] == pytest.approx(96 * 96 / line["sweep_s_median"])


@pytest.mark.parametrize("n,rb", [(96, 32), (70, 16), (40, 64), (33, 8)])
@pytest.mark.parametrize("method,kernel", [("split", "split_gram"),
                                           ("popcount", "popcount_gram")])
def test_pair_count_equals_the_blocks_the_kernels_received(monkeypatch, n, rb, method,
                                                           kernel):
    """Sum of rows x columns over the gram calls of the sweeps equals the
    pair count under ``mfu`` (once a sweep: two warm-ups and ``iters``)."""
    seen = []
    real = getattr(port_pairsnp, kernel)

    def spy(a, *args):
        # split_gram(ea, nm, r0, rb, c0, eb, nmb); popcount_gram(pa, r0, rb, c0, pb)
        _r0, rows, c0, b = args[1:5] if kernel == "split_gram" else args[:4]
        seen.append(rows * ((a if b is None else b).shape[0] - c0))
        return real(a, *args)

    monkeypatch.setattr(port_pairsnp, kernel, spy)
    res = port_bench.bench_gpu(packed=_headline(n, 2000), row_block=rb, method=method,
                               device="cpu", iters=2)
    assert res["pairs"] == port_bench.swept_pairs(n, rb)
    assert len(seen) == 4 * -(-n // rb)
    assert sum(seen) == 4 * res["pairs"]


@pytest.mark.parametrize("method,builds", [("split", "split_layout"),
                                           ("popcount", "pad_planes"), ("mxu", "pad_planes")])
def test_layout_is_built_once(monkeypatch, method, builds):
    """The first warm-up builds and uploads the device layout; nothing
    rebuilds it, so the timed sweeps run on the resident one."""
    from tracs_tpu_torch.ops import kernels

    calls = []
    where = kernels if builds == "split_layout" else port_pairsnp  # split_alignment's kernel
    real = getattr(where, builds)
    monkeypatch.setattr(where, builds, lambda *a: calls.append(1) or real(*a))
    port_bench.bench_gpu(packed=_headline(40, 3000), row_block=16, method=method,
                         device="cpu", iters=3)
    assert len(calls) == 1


def test_a_layout_rebuilt_inside_the_timed_sweeps_fails(monkeypatch):
    real = port_bench.sweep
    n_calls = []

    def forgetful(packed, **kw):
        n_calls.append(1)
        if len(n_calls) == 4:  # the second timed sweep
            packed._split_cache._dev_cache = None
        return real(packed, **kw)

    monkeypatch.setattr(port_bench, "sweep", forgetful)
    with pytest.raises(RuntimeError, match="rebuilt inside the timed sweeps"):
        port_bench.bench_gpu(packed=_headline(40, 3000), row_block=16, device="cpu", iters=3)


@pytest.mark.parametrize("n,L", [(12, 333), (9, 64), (5, 1000)])
def test_cpu_reference_row_matches_snp_distance_dense(n, L):
    """``reference_row`` (bench.py's inner loop) on 64-bit words gives
    tracs_tpu's ``snp_distance_dense`` D and NN on the same planes."""
    from tracs_tpu.ops.packing import pack_sequences
    from tracs_tpu.ops.pairsnp import snp_distance_dense

    rng = np.random.default_rng(n * L)
    j = pack_sequences(["".join(rng.choice(IUPAC, size=L)) for _ in range(n)])
    planes = np.asarray(j.planes, dtype=np.uint32)
    if planes.shape[2] % 2:  # a zero word shares nothing and counts no N
        planes = np.concatenate([planes, np.zeros((n, 4, 1), np.uint32)], axis=2)
    words64 = np.ascontiguousarray(planes).view(np.uint64)  # little-endian: site order kept
    D, NN = (np.asarray(x) for x in snp_distance_dense(j))
    for i in range(n):
        d, nn = port_bench.reference_row(words64, i, L)
        assert np.array_equal(d, D[i]) and np.array_equal(nn, NN[i])


def test_cpu_reference_rate_is_positive():
    assert port_bench.bench_cpu_reference(n_rows=2, n=16, L=4096) > 0


def test_cuda_without_a_card_raises_and_the_cli_exits_1():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(DeviceUnavailableError):
        port_bench.run(16, 640, device="cuda")
    r = subprocess.run([sys.executable, "-m", "tracs_tpu_torch.experiments.bench", "--n", "16",
                        "--length", "640"], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and r.stdout == ""
    assert "torch.cuda.is_available() is False" in r.stderr


def test_import_leaves_jax_unloaded():
    code = ("import sys; import tracs_tpu_torch.experiments.bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tracs_tpu', 'bench')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
