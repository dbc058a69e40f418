"""The port's on-disk pack cache (``pack_fasta(path, cache_dir=...)``) on
the CPU: the four cases of tests/test_pack_cache.py with the directory given
as an argument where tracs_tpu reads ``TRACS_TPU_PACK_CACHE``; the key's
whole-file stamps (an edit that restores size and modification time still
re-keys); a corrupt entry re-packed; a failed store that still returns the
planes; and ``distance --pack-cache`` writing the same CSV bytes cold and
warm, equal to tracs_tpu's."""

import gzip
import json
import os
import time

import numpy as np
import pytest

from tracs_tpu_torch import cli as port_cli
from tracs_tpu_torch.ops import packing
from tracs_tpu_torch.ops.pairsnp import snp_distance_dense

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture
def fasta(tmp_path, rng):
    p = tmp_path / "aln.fasta.gz"
    seqs = ["".join(rng.choice(list("ACGTN"), size=211)) for _ in range(9)]
    with gzip.open(p, "wt") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i}\n{s}\n")
    return str(p)


def _rewrite(path, text):
    """Rewrite ``path`` in place after the file system's clock has moved on."""
    time.sleep(0.05)
    with gzip.open(path, "wt") as fh:
        fh.write(text)


def test_cache_roundtrip_and_hit(fasta, tmp_path):
    cache = tmp_path / "cache"
    first = packing.pack_fasta(fasta, cache_dir=cache)
    entry = cache / packing.pack_cache_key(fasta)
    assert (entry / "planes.npy").exists() and (entry / "meta.json").exists()
    assert [p.name for p in cache.iterdir()] == [entry.name]  # no temporary left

    again = packing.pack_fasta(fasta, cache_dir=cache)
    assert isinstance(again.planes, np.memmap) and not again.planes.flags.writeable
    assert np.array_equal(np.asarray(again.planes), first.planes)
    assert again.names == first.names and again.length == first.length

    # the mmap'd alignment drives both engines unchanged
    for method in ("split", "popcount", "mxu"):
        D1, NN1 = snp_distance_dense(first, device="cpu", method=method)
        D2, NN2 = snp_distance_dense(again, device="cpu", method=method)
        assert np.array_equal(D1, D2) and np.array_equal(NN1, NN2)


def test_cache_invalidated_by_content_change(fasta, tmp_path):
    cache = tmp_path / "cache"
    packing.pack_fasta(fasta, cache_dir=cache)
    key1 = packing.pack_cache_key(fasta)
    _rewrite(fasta, gzip.open(fasta, "rt").read().replace("A", "C", 1))
    assert packing.pack_cache_key(fasta) != key1
    fresh = packing.pack_fasta(fasta, cache_dir=cache)
    assert fresh.n_seqs == 9 and not isinstance(fresh.planes, np.memmap)
    assert fresh.planes.tobytes() == packing.pack_fasta(fasta).planes.tobytes()


def test_any_size_is_cached_when_a_directory_is_given(fasta, tmp_path):
    """``cache_dir`` is the only switch: a file of a few hundred bytes is
    cached (tracs_tpu skips files under 64 MB by default), and a second file
    gets an entry of its own beside the first."""
    cache = tmp_path / "cache"
    packing.pack_fasta(fasta, cache_dir=cache)
    assert os.path.getsize(fasta) < 4096
    assert [p.name for p in cache.iterdir()] == [packing.pack_cache_key(fasta)]
    other = tmp_path / "other.fasta"
    other.write_bytes(b">s0\nACGT\n>s1\nACGA\n")
    got = packing.pack_fasta(other, cache_dir=cache)
    assert got.names == ["s0", "s1"] and got.length == 4
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [packing.pack_cache_key(fasta), packing.pack_cache_key(other)])


def test_cache_disabled_without_directory(fasta, tmp_path, monkeypatch):
    """No ``cache_dir``: nothing is written, nowhere."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    before = sorted(os.listdir(tmp_path))
    assert packing.pack_fasta(fasta).n_seqs == 9
    assert packing.pack_fasta(fasta, cache_dir=None).n_seqs == 9
    assert sorted(os.listdir(tmp_path)) == before


def test_edit_that_restores_size_and_mtime_rekeys(fasta, tmp_path):
    """The reference's key (size, mtime and 16 sampled stripes) misses an
    edit that keeps size and mtime between its stripes; ctime cannot be set
    back from user space, so the port's key changes."""
    cache = tmp_path / "cache"
    first = packing.pack_fasta(fasta, cache_dir=cache)
    key1 = packing.pack_cache_key(fasta)
    st = os.stat(fasta)
    text = gzip.open(fasta, "rt").read()
    _rewrite(fasta, text.replace("C", "G", 1))
    raw = open(fasta, "rb").read()
    with open(fasta, "wb") as fh:  # same size: pad or cut the gzip trailer's slack
        fh.write(raw[:st.st_size].ljust(st.st_size, b"\0"))
    os.utime(fasta, ns=(st.st_atime_ns, st.st_mtime_ns))
    st2 = os.stat(fasta)
    assert (st2.st_size, st2.st_mtime_ns) == (st.st_size, st.st_mtime_ns)
    assert packing.pack_cache_key(fasta) != key1
    assert not (cache / packing.pack_cache_key(fasta)).exists()
    assert len(first.names) == 9


def test_key_holds_the_packer_version(fasta, monkeypatch):
    key = packing.pack_cache_key(fasta)
    monkeypatch.setattr(packing, "PACKER_VERSION", packing.PACKER_VERSION + 1)
    assert packing.pack_cache_key(fasta) != key


@pytest.mark.parametrize("damage", ["meta", "planes", "version", "shape"])
def test_corrupt_entry_is_repacked(fasta, tmp_path, caplog, damage):
    cache = tmp_path / "cache"
    want = packing.pack_fasta(fasta, cache_dir=cache)
    entry = cache / packing.pack_cache_key(fasta)
    meta = json.loads((entry / "meta.json").read_text())
    if damage == "meta":
        (entry / "meta.json").write_text("{not json")
    elif damage == "planes":
        (entry / "planes.npy").write_bytes(b"\x93NUMPY garbage")
    elif damage == "version":
        (entry / "meta.json").write_text(json.dumps({**meta, "version": -1}))
    else:
        (entry / "meta.json").write_text(json.dumps({**meta, "names": meta["names"][:3]}))
    got = packing.pack_fasta(fasta, cache_dir=cache)
    assert "corrupt" in caplog.text and "re-packing" in caplog.text
    assert not isinstance(got.planes, np.memmap)
    assert np.array_equal(got.planes, want.planes) and got.names == want.names
    again = packing.pack_fasta(fasta, cache_dir=cache)  # stored anew
    assert isinstance(again.planes, np.memmap)
    assert np.array_equal(np.asarray(again.planes), want.planes)


def test_failed_store_warns_and_returns_the_planes(fasta, tmp_path, caplog):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the cache directory should be")
    got = packing.pack_fasta(fasta, cache_dir=blocker)
    assert got.n_seqs == 9 and "could not store" in caplog.text


@pytest.mark.parametrize("flags", [[], ["--row-block", "2"], ["--filter"]])
def test_distance_pack_cache_cold_and_warm_write_the_same_bytes(tmp_path, flags):
    pytest.importorskip("jax")
    from tracs_tpu import cli as jax_cli

    msa = os.path.join(DATA, "long_filt_style.aln" if "--filter" in flags else "ambig.aln")
    cache = tmp_path / "cache"
    outs = []
    for run in ("cold", "warm"):
        out = str(tmp_path / f"{run}.csv")
        port_cli.main(["distance", "--msa", msa, "-o", out, "--device", "cpu",
                       "--pack-cache", str(cache), *flags])
        outs.append(open(out, "rb").read())
        assert [p.name for p in cache.iterdir()] == [packing.pack_cache_key(msa)]
    jax_cli.main(["distance", "--msa", msa, "-o", str(tmp_path / "jax.csv"), "--mesh", "off",
                  *flags])
    assert outs[0] == outs[1] == (tmp_path / "jax.csv").read_bytes()
