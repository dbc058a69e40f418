"""The split layout (ops/packing.py::split_alignment, the kernels
``split_layout`` and ``split_gather`` of ops/kernels.py), built by one route
on the device that asks for it.

Here on the CPU: ``split_alignment`` without a device builds on the CPU,
with the kernels' plain versions, and a layout asked for on another device
builds that device's tensors once and keeps them.  On a card (``-m cuda``):
each kernel against its plain version, exact, on every bit pattern of the
words, at word counts below, at and past the card's pitch and across the
layout kernel's blocks of words and of samples; the layout built on the card
against the CPU's; and a split-engine ``distance --meta --filter`` run on a
layout built on the card against the same run on a layout built on the CPU
and crossed to the card, byte for byte, with the kernel's launches and the
device builds counted; a query-vs-db pair on layouts built on the card
against the CPU.  The tests against tracs_tpu are in
tests/test_torch_pairsnp.py; this file imports no jax."""

import os

import numpy as np
import pytest
import torch

from tracs_tpu_torch import cli
from tracs_tpu_torch.ops import kernels
from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops.packing import pack_sequences, split_alignment
from tracs_tpu_torch.runtime import profiling

IUPAC = np.array(list("ACGTMRWSYKVHDBN-"))
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _packed(rng, n, L, alphabet=IUPAC):
    return pack_sequences(["".join(rng.choice(alphabet, size=L)) for _ in range(n)])


@pytest.mark.parametrize("device", [None, "cpu", CPU])
def test_split_alignment_without_a_card_stays_on_the_host(device):
    """Without a card the layout is built on the CPU: its tensors, at the
    card's word pitch, are its only planes, and no build on a card is
    counted."""
    rng = np.random.default_rng(1)
    p = _packed(rng, 5, 100)
    before = profiling.counter("layout.device_builds")
    sent = profiling.counter("layout.upload_bytes")
    sa = split_alignment(p) if device is None else split_alignment(p, device=device)
    assert sa.device == CPU and list(sa._dev_cache) == [CPU]
    assert not any(hasattr(sa, f) for f in ("excl", "nmask", "partial"))
    ea, nm, pt = port._split_device(sa, CPU)
    for t in (ea, nm, pt, port._cnt_device(sa, CPU)):
        assert t.device == CPU and t.dtype == torch.int32
    assert ea.shape == (5, 4, kernels.padded_words(p.planes.shape[2])) and sa.n_seqs == 5
    assert profiling.counter("layout.device_builds") == before
    assert profiling.counter("layout.upload_bytes") == sent + p.planes.nbytes


def test_a_run_rebuilds_a_device_layout_that_does_not_serve_it():
    """A layout asked for on another device builds that device's tensors
    once, from ``src`` at its own partial positions, and keeps them beside
    its own; a run on another device builds a layout of its own."""
    rng = np.random.default_rng(2)
    p, other = _packed(rng, 4, 70), _packed(rng, 3, 70)
    sites = np.union1d(port.partial_site_positions(p), port.partial_site_positions(other))
    sa = split_alignment(p, sites)
    held = sa._dev_cache
    elsewhere = torch.device("cpu", 0)  # a second key: the CPU is this machine's only device
    sent = profiling.counter("layout.upload_bytes")
    got = port._split_device(sa, elsewhere)
    assert profiling.counter("layout.upload_bytes") == sent + p.planes.nbytes
    assert port._split_device(sa, elsewhere)[0] is got[0] and sa._dev_cache is held
    assert profiling.counter("layout.upload_bytes") == sent + p.planes.nbytes
    assert list(held) == [CPU, elsewhere] and sa.device == CPU
    for g, w in zip(got + (port._cnt_device(sa, elsewhere),), held[CPU]):
        assert g is not w and torch.equal(g, w)
    p._split_cache = sa
    assert port._cached_split(p, CPU) is sa and port._cached_split(p, None) is sa
    mine = port._cached_split(p, elsewhere)
    assert mine is not sa and mine.device == elsewhere and p._split_cache is mine


def test_an_empty_alignment_has_an_empty_layout():
    planes = torch.zeros((0, 4, 3), dtype=torch.int32)
    excl, nmask, cnt_n, partial_or = kernels.split_layout(planes)
    assert (excl.shape, nmask.shape, cnt_n.shape) == ((0, 4, 4), (0, 4), (0,))
    assert partial_or.shape == (3,) and not partial_or.any()
    assert kernels.split_gather(excl, np.array([1, 70])).shape == (0, 4, 4)


# -- on the card --

def _random_planes(rng, n, W):
    """int32 [n, 4, W] raw planes of every bit pattern, so all-N, partial and
    empty sites (the pad of a ragged length reads as empty) all occur."""
    words = rng.integers(0, 2**32, size=(n, 4, W), dtype=np.uint64).astype(np.uint32)
    words[::5] = np.uint32(0xFFFFFFFF)  # some all-N rows
    return torch.from_numpy(words.view(np.int32))


#: (samples, words): below, at and past the pitch of 4, one sample, samples
#: across the kernel's groups of 32, words across its chunks of 1,024
KERNEL_CASES = [(1, 1), (3, 3), (7, 4), (33, 5), (64, 17), (65, 1030), (129, 2051)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,W", KERNEL_CASES)
def test_split_layout_kernel_matches_plain(cuda_device, n, W):
    rng = np.random.default_rng(n * 10007 + W)
    planes = _random_planes(rng, n, W).to(cuda_device)
    got = kernels.split_layout(planes)
    want = kernels.split_layout_reference(planes)
    torch.cuda.synchronize()
    for name, g, w in zip(("excl", "nmask", "cnt_n", "partial_or"), got, want):
        assert g.shape == w.shape and torch.equal(g, w), name
    assert got[0].shape[2] == kernels.padded_words(W)
    # the gather at a ragged few sites, at sites past 32 words, and at none
    for P in (0, 5, min(32 * W, 97), 32 * W):
        pos = np.sort(rng.choice(32 * W, size=P, replace=False)).astype(np.int64)
        g, w = kernels.split_gather(got[0], pos), kernels.split_gather_reference(got[0], pos)
        torch.cuda.synchronize()
        assert g.shape == w.shape and torch.equal(g, w), P


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["split", "auto"])
def test_query_vs_db_on_card_layouts_matches_the_cpu(cuda_device, method):
    """A query-vs-db pair: both sides built on the card at the union of their
    partial sites give the D and NN of the CPU's layouts."""
    rng = np.random.default_rng(5)
    a, b = _packed(rng, 21, 2500), _packed(rng, 34, 2500, np.array(list("ACGTYN")))
    builds = profiling.counter("layout.device_builds")
    got = port.snp_distance_dense(a, b, device=cuda_device, method=method, row_block=8)
    assert profiling.counter("layout.device_builds") == builds + 2
    sa, sb = port._split_pair(a, b, cuda_device)
    assert sa.device == sb.device == cuda_device
    assert np.array_equal(sa.partial_pos, sb.partial_pos) and sa.n_partial > 0
    want = port.snp_distance_dense(a, b, device="cpu", method=method, row_block=8)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_comparable_sites_pairs_on_a_card_layout_matches_the_cpu(cuda_device):
    """A layout whose planes live only on the card gives the listed pairs'
    comparable sites, as the CPU's layout does, and so does a CPU layout
    asked for on the card."""
    rng = np.random.default_rng(6)
    p = _packed(rng, 30, 2100)
    ii, jj = np.divmod(np.arange(30 * 30), 30)
    want = port.comparable_sites_pairs(split_alignment(p), split_alignment(p), ii, jj,
                                       device="cpu")
    on_card = split_alignment(p, device=cuda_device)
    got = port.comparable_sites_pairs(on_card, on_card, ii, jj, device=cuda_device, batch=77)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    on_cpu = split_alignment(p)
    assert np.array_equal(port.comparable_sites_pairs(on_cpu, on_cpu, ii, jj,
                                                      device=cuda_device), want)
    assert cuda_device in on_cpu._dev_cache


def _clustered_aln(path, rng, n, L):
    """A FASTA of ``n`` samples in clusters of 4 around random bases, with
    substitutions, IUPAC codes and N runs, and its names."""
    base = rng.choice(np.array(list("ACGT")), size=(n // 4 + 1, L))
    names = [f"s{k}" for k in range(n)]
    with open(path, "w") as fh:
        for k in range(n):
            s = base[k // 4].copy()
            hit = rng.random(L) < 0.01
            s[hit] = rng.choice(IUPAC, size=int(hit.sum()))
            fh.write(f">{names[k]}\n{''.join(s)}\n")
    return str(path), names


@pytest.mark.cuda
def test_card_layout_matches_the_host_layout(cuda_device):
    """The layout built on the card: the CPU's one-route layout, word for
    word, with one device build and one layout launch."""
    rng = np.random.default_rng(3)
    p = _packed(rng, 45, 1337)
    host = split_alignment(p)
    builds = profiling.counter("layout.device_builds")
    launches = profiling.counter("kernel.launches.split_layout")
    dev = split_alignment(p, device=cuda_device)
    assert profiling.counter("layout.device_builds") == builds + 1
    assert profiling.counter("kernel.launches.split_layout") == launches + 1
    assert dev.device == cuda_device and list(dev._dev_cache) == [cuda_device]
    assert np.array_equal(dev.cnt_n, host.cnt_n) and np.array_equal(dev.partial_pos,
                                                                    host.partial_pos)
    got = port._split_device(dev, cuda_device) + (port._cnt_device(dev, cuda_device),)
    want = port._split_device(host, CPU) + (port._cnt_device(host, CPU),)
    for g, w in zip(got, want):
        assert g.device == cuda_device and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_distance_on_a_card_layout_writes_the_host_layout_bytes(cuda_device, tmp_path,
                                                                monkeypatch):
    """``distance --meta --filter`` on the card, once with its layout built
    there and once with a layout built on the CPU whose card tensors the
    run builds from its raw planes: the same CSV bytes; each counts one
    device build and one layout launch (the CPU's build counts none)."""
    rng = np.random.default_rng(4)
    msa, names = _clustered_aln(tmp_path / "c.fasta", rng, 40, 3000)
    with open(tmp_path / "dates.csv", "w") as fh:
        fh.write("name,date\n")
        for k, name in enumerate(names):
            fh.write(f"{name},2020-0{1 + k % 4}-{10 + k % 17}\n")

    def run(out):
        builds = profiling.counter("layout.device_builds")
        launches = profiling.counter("kernel.launches.split_layout")
        cli.main(["distance", "--msa", msa, "-o", str(out), "--meta", str(tmp_path / "dates.csv"),
                  "--filter", "-D", "200", "--row-block", "16", "--device", "cuda"])
        with open(out, "rb") as fh:
            return (fh.read(), profiling.counter("layout.device_builds") - builds,
                    profiling.counter("kernel.launches.split_layout") - launches)

    card, card_builds, card_launches = run(tmp_path / "card.csv")
    real = port._cached_split
    monkeypatch.setattr(port, "_cached_split", lambda packed, device=None: real(packed, CPU))
    host, host_builds, host_launches = run(tmp_path / "host.csv")
    assert card == host and card.count(b"\n") > 20
    assert (card_builds, card_launches, host_builds, host_launches) == (1, 1, 1, 1)
    assert os.path.getsize(tmp_path / "card.csv") == len(card)
