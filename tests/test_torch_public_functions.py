"""The port's module-level public functions that tracs_tpu has and the port
gained last (``io/fasta.py::write_fasta``; ``ops/pairsnp.py``'s
``comparable_sites_dense``, ``comparable_sites_pairs`` and
``snp_distance_dense_split``) against their tracs_tpu counterparts on the
same numpy-seeded inputs: the FASTA's bytes, exact arrays otherwise.  A
module-level public function of tracs_tpu's ``io/fasta.py``,
``ops/packing.py``, ``ops/pairsnp.py`` and ``parallel/mesh.py`` that the port
lacks, or whose parameters differ from tracs_tpu's beyond the departures
named here, fails a test; so does ``snp_distance_split_device(with_nn=False)``
unless it returns (D, None), as tracs_tpu's does.

jax is imported inside the tests that need it, so the card-only tests run on
a machine without it."""

import gzip
import inspect

import numpy as np
import pytest
import torch

from tracs_tpu_torch.io import fasta as port_fasta
from tracs_tpu_torch.ops import pairsnp as port
from tracs_tpu_torch.ops.packing import from_reference, split_alignment
from tracs_tpu_torch.runtime.device import DeviceUnavailableError

IUPAC = np.array(list("ACGTMRWSYKVHDBN-"))


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    from tracs_tpu.ops import packing as jpacking
    from tracs_tpu.ops import pairsnp as jref

    return jpacking, jref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _seqs(rng, n, L):
    return ["".join(rng.choice(IUPAC, size=L)) for _ in range(n)]


def _pair(jax_ref, rng, na, nb, L):
    """(JAX SplitAlignments (sa, sb), the port's (sa, sb)) of a query-vs-db
    pair gathered at one partial-site axis, by each package's ``_split_pair``;
    ``nb`` 0 gives the self pair (sb is sa)."""
    jpacking, jref = jax_ref
    ja = jpacking.pack_sequences(_seqs(rng, na, L))
    jb = jpacking.pack_sequences(_seqs(rng, nb, L)) if nb else None
    pa = from_reference(ja.planes, ja.length, ja.names)
    pb = from_reference(jb.planes, jb.length, jb.names) if nb else None
    return jref._split_pair(ja, jb), port._split_pair(pa, pb)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("width", [0, 1, 7, 60, 1000])
def test_write_fasta_matches_reference(tmp_path, width, gz):
    from tracs_tpu.io import fasta as jfasta

    rng = np.random.default_rng(width)
    records = [(f"s{k} note", "".join(rng.choice(IUPAC, size=int(rng.integers(0, 300)))))
               for k in range(6)]
    records.append(("empty", ""))
    suffix = ".fa.gz" if gz else ".fa"
    got, want = tmp_path / f"port{suffix}", tmp_path / f"ref{suffix}"
    port_fasta.write_fasta(got, iter(records), width=width)
    jfasta.write_fasta(str(want), records, width=width)
    read = gzip.decompress if gz else bytes  # a gzip header carries the write time
    assert read(got.read_bytes()) == read(want.read_bytes())
    assert list(port_fasta.read_fasta(got)) == [(n.split()[0], s) for n, s in records]


@pytest.mark.parametrize("na,nb,L", [(9, 0, 333), (6, 5, 70), (1, 1, 32)])
def test_comparable_sites_dense_matches_reference(jax_ref, na, nb, L):
    _, jref = jax_ref
    rng = np.random.default_rng(na + nb + L)
    (jsa, jsb), (sa, sb) = _pair(jax_ref, rng, na, nb, L)
    got = port.comparable_sites_dense(sa, sb, device="cpu")
    want = jref.comparable_sites_dense(jsa, jsb)
    assert got.dtype == np.int32 and got.shape == (na, nb or na)
    assert np.array_equal(got, want)
    _, NN = port.snp_distance_dense_split(sa, sb, device="cpu")
    assert np.array_equal(got, NN)


@pytest.mark.parametrize("batch", [3, 65536])
@pytest.mark.parametrize("nb", [0, 7])
def test_comparable_sites_pairs_matches_reference(jax_ref, nb, batch):
    _, jref = jax_ref
    rng = np.random.default_rng(nb + batch)
    (jsa, jsb), (sa, sb) = _pair(jax_ref, rng, 11, nb, 400)
    pi = rng.integers(0, 11, size=20)
    pj = rng.integers(0, nb or 11, size=20)
    got = port.comparable_sites_pairs(sa, sb, pi, pj, device="cpu", batch=batch)
    want = jref.comparable_sites_pairs(jsa, jsb, pi, pj, batch=batch)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    dense = port.comparable_sites_dense(sa, sb, device="cpu")
    assert np.array_equal(got, dense[pi, pj])
    assert len(port.comparable_sites_pairs(sa, sb, [], [], device="cpu")) == 0


@pytest.mark.parametrize("with_nn", [True, False])
@pytest.mark.parametrize("na,nb,L", [(13, 0, 257), (5, 8, 90)])
def test_snp_distance_dense_split_matches_reference(jax_ref, na, nb, L, with_nn):
    _, jref = jax_ref
    rng = np.random.default_rng(na * nb + L)
    (jsa, jsb), (sa, sb) = _pair(jax_ref, rng, na, nb, L)
    D, NN = port.snp_distance_dense_split(sa, None if nb == 0 else sb, device="cpu",
                                          with_nn=with_nn)
    Dj, NNj = jref.snp_distance_dense_split(jsa, None if nb == 0 else jsb, with_nn=with_nn)
    assert D.dtype == np.int32 and np.array_equal(D, Dj)
    if with_nn:
        assert NN.dtype == np.int32 and np.array_equal(NN, NNj)
    else:
        assert NN is None and NNj is None


def test_split_functions_refuse_unshared_partial_axes(jax_ref):
    jpacking, _ = jax_ref
    rng = np.random.default_rng(2)
    a, b = (split_alignment(from_reference(j.planes, j.length, j.names))
            for j in (jpacking.pack_sequences(_seqs(rng, 4, 200)) for _ in range(2)))
    assert not np.array_equal(a.partial_pos, b.partial_pos)
    for fn in (port.comparable_sites_dense, port.snp_distance_dense_split):
        with pytest.raises(ValueError, match="partial-site gather axis"):
            fn(a, b, device="cpu")


@pytest.mark.parametrize("name", ["comparable_sites_dense", "comparable_sites_pairs",
                                  "snp_distance_dense_split"])
def test_cuda_without_a_card_raises(jax_ref, name):
    """Each takes ``device=``; asking for a card that is absent raises, no
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rng = np.random.default_rng(3)
    _, (sa, sb) = _pair(jax_ref, rng, 4, 0, 64)
    args = (sa, sb, [0], [1]) if name == "comparable_sites_pairs" else (sa, sb)
    with pytest.raises(DeviceUnavailableError):
        getattr(port, name)(*args, device="cuda")


def test_no_public_function_of_the_reference_is_missing():
    """Every module-level public function of tracs_tpu's ``io/fasta.py`` and
    ``ops/pairsnp.py`` has a counterpart of the same name in the port, but
    the TPU machinery left out on purpose."""
    from tracs_tpu.io import fasta as jfasta
    from tracs_tpu.ops import pairsnp as jref

    machinery = {"plan_chunks", "prefix_col_start", "schedule_mac_pairs"}
    for ref, mine in ((jfasta, port_fasta), (jref, port)):
        public = {n for n, f in vars(ref).items() if not n.startswith("_")
                  and inspect.isfunction(f) and f.__module__ == ref.__name__}
        missing = sorted(public - machinery - set(dir(mine)))
        assert missing == [], f"{mine.__name__} lacks {missing}"


#: tracs_tpu's public functions the port leaves out on purpose: TPU machinery
#: (prefix bucketing and the chunk planner) and ``parallel/mesh.py::to_host``,
#: which takes a ``jax.Array`` (the port's is ``runtime/device.py::to_host``)
MACHINERY = {"plan_chunks", "prefix_col_start", "schedule_mac_pairs", "to_host"}
#: the port's departures from tracs_tpu's parameter lists, by function:
#: (parameters of tracs_tpu's that the port drops, parameters it adds); every
#: function also takes the keyword ``device``.  ``make_mesh`` spans the whole
#: world of processes; ``pack_fasta``'s cache is a directory the caller names
#: (tracs_tpu's ``use_cache`` turns on a directory read from the environment,
#: and the port reads none); ``r0``/``r1`` pick rows of the split block and
#: ``method`` the engine whose resident layout the mismatch kernel reads.
DEPARTURES = {
    "make_mesh": ({"devices"}, set()),
    "pack_fasta": ({"use_cache"}, {"cache_dir"}),
    "snp_distance_split_device": (set(), {"r0", "r1"}),
    "mismatch_positions_device": (set(), {"method"}),
}
MODULES = ["io.fasta", "ops.packing", "ops.pairsnp", "parallel.mesh"]


@pytest.mark.parametrize("module", MODULES)
def test_public_signatures_match_the_reference(module):
    """Every module-level public function of tracs_tpu's ``module`` exists in
    the port's (but ``MACHINERY``) with the same parameter names, in the same
    order and of the same kinds, but the added ``device`` and
    ``DEPARTURES``."""
    import importlib

    pytest.importorskip("jax")
    ref = importlib.import_module(f"tracs_tpu.{module}")
    mine = importlib.import_module(f"tracs_tpu_torch.{module}")
    public = sorted(n for n, f in vars(ref).items() if not n.startswith("_")
                    and inspect.isfunction(f) and f.__module__ == ref.__name__)
    assert public
    for name in public:
        if name in MACHINERY:
            continue
        assert hasattr(mine, name), f"{mine.__name__} lacks {name}"
        dropped, added = DEPARTURES.get(name, (set(), set()))
        want = [(p.name, p.kind) for p in inspect.signature(getattr(ref, name)).parameters.values()
                if p.name not in dropped]
        got = [(p.name, p.kind) for p in inspect.signature(getattr(mine, name)).parameters.values()
               if p.name not in added | {"device"}]
        assert got == want, f"{module}.{name}"


@pytest.mark.parametrize("na,nb,L", [(13, 0, 257), (5, 8, 90)])
def test_split_device_without_nn_returns_none(jax_ref, na, nb, L):
    """``snp_distance_split_device(with_nn=False)`` gives (D, None), D equal
    to tracs_tpu's, as tracs_tpu's does."""
    _, jref = jax_ref
    rng = np.random.default_rng(na + 3 * nb + L)
    (jsa, jsb), (sa, sb) = _pair(jax_ref, rng, na, nb, L)
    D, NN = port.snp_distance_split_device(sa, None if nb == 0 else sb, with_nn=False,
                                           device="cpu")
    Dj, NNj = jref.snp_distance_split_device(jsa, None if nb == 0 else jsb, with_nn=False)
    assert NN is None and NNj is None
    assert D.dtype == torch.int32 and np.array_equal(D.numpy(), np.asarray(Dj))
    Dw, NNw = port.snp_distance_split_device(sa, None if nb == 0 else sb, chunk_sites=64,
                                             device="cpu")
    assert torch.equal(D, Dw) and NNw.shape == D.shape


def test_chunk_keywords_are_accepted_and_ignored(jax_ref):
    """``chunk_sites`` and ``chunk`` size tracs_tpu's TPU chunks: the port
    takes them and gives the same arrays whatever they are."""
    jpacking, _ = jax_ref
    rng = np.random.default_rng(4)
    j = jpacking.pack_sequences(_seqs(rng, 9, 300))
    p = from_reference(j.planes, j.length, j.names)
    D, NN = port.snp_distance_dense(p, device="cpu")
    for method in ("split", "popcount"):
        Dc, NNc = port.snp_distance_dense(p, device="cpu", method=method, chunk_sites=64)
        assert np.array_equal(D, Dc) and np.array_equal(NN, NNc)
    sa = split_alignment(p)
    Ds, _ = port.snp_distance_dense_split(sa, chunk_sites=32, device="cpu")
    assert np.array_equal(D, Ds)
    pi, pj = np.array([0, 1, 2]), np.array([3, 4, 8])
    want = port.mismatch_positions_device(p, p, pi, pj, 64, device="cpu")
    got = port.mismatch_positions_device(p, p, pi, pj, 64, chunk=1, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert np.array_equal(got[0], D[pi, pj])


# -- on the card --

@pytest.mark.cuda
def test_comparable_sites_dense_cuda_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    from tracs_tpu_torch.ops.packing import pack_sequences

    sa = split_alignment(pack_sequences(_seqs(rng, 40, 1000)))
    got = port.comparable_sites_dense(sa, sa, device=cuda_device)
    assert np.array_equal(got, port.comparable_sites_dense(sa, sa, device="cpu"))
    D, NN = port.snp_distance_dense_split(sa, device=cuda_device)
    Dc, NNc = port.snp_distance_dense_split(sa, device="cpu")
    assert np.array_equal(D, Dc) and np.array_equal(NN, NNc) and np.array_equal(got, NN)
