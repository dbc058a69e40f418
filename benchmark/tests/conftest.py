"""Shared pieces of the benchmark's tests: tiny sizes of each configuration,
the clock and mixtures structures as overrides, a mixtures alignment rebuilt
from its draws, and one harness run of a cell on the CPU."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

TINY = {"bact-1mb-10000": {"samples": 90, "sites": 29903, "row_block": 32},
        "bact-1mb-4096": {"samples": 48, "sites": 20000, "row_block": 16},
        "sc2-30kb-32768": {"samples": 90, "sites": 29903, "row_block": 32}}
CELLS = ["bact-1mb-10000.sweep", "bact-1mb-4096.job", "bact-1mb-4096.filter-job"]
#: the generator's clock structure at SARS-CoV-2's 29,903 sites and upstream's
#: default clock rate, as an override of a cell's configuration
CLOCK = {"structure": "clock", "max_mutations": None, "sites": 29903, "cluster_size": 21,
         "clock_rate": 29.903000000000002}

#: the generator's mixtures structure, as an override of a cell's
#: configuration: a tenth of the sites segregating, minor alleles at a fifth,
#: three tenths of the samples carrying a second strain
MIXTURES = {"structure": "mixtures", "segregating_share": 0.1, "minor_allele_share": 0.2,
            "mixed_share": 0.3, "strains": 2}


def tiny(cell: str) -> dict:
    return TINY[cell.split(".")[0]]


def mixtures(**changes) -> dict:
    """A small mixtures configuration, with ``changes``."""
    cfg = {"samples": 120, "sites": 6000, "cluster_size": 7, "max_mutations": 90,
           "partial_columns": 40, "n_share": 0.05}
    return {**cfg, **MIXTURES, **changes}


@pytest.fixture
def run_cell(monkeypatch):
    from benchmark import harness

    # the test process holds jax and tracs_tpu for the reference tests; the
    # rule itself is tested in a fresh process (test_bench_cells.py)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def run(cell, seed=2**31 + 5, seconds=0.2, trace=False, **kw):
        if "overrides" not in kw:
            kw["overrides"] = tiny(cell)
        return harness.run(cell, seed, seconds, trace, t0=time.perf_counter(), device="cpu", **kw)
    return run


def rebuilt_mixtures(cfg: dict, seed: int) -> SimpleNamespace:
    """A mixtures alignment's codes rebuilt site by site from its exposed
    draws, apart from the generator's planes: ``draws``; ``root`` [L] and
    ``strain`` [n, L] codes; ``mixed`` [n, L], each sample's code as the OR
    of its strains' bases; ``is_n`` [n, L], each sample's own N, drawn
    after the mixtures from the same generator; and ``partial`` [L], the
    M/R columns drawn after them."""
    from benchmark import generate

    n, L, cs = cfg["samples"], cfg["sites"], cfg["cluster_size"]
    root = generate.random_planes(1, L, 0.0, seed)
    rng = np.random.default_rng(seed + 1)
    draws = generate.mixture_draws(
        root, L, n=n, cluster_size=cs, max_mut=cfg["max_mutations"],
        segregating_share=cfg["segregating_share"],
        minor_allele_share=cfg["minor_allele_share"], mixed_share=cfg["mixed_share"],
        strains=cfg["strains"], rng=rng)
    root_code = generate.planes_to_nibbles(root, L)[0]
    founder = np.repeat(root_code[None], len(draws.alleles), axis=0)
    founder[:, draws.seg_site] = np.where(draws.alleles, np.uint8(1) << draws.seg_base,
                                          root_code[draws.seg_site])
    strain = founder[np.arange(n) // cs]
    sample, site, base = draws.own
    strain[sample, site] = np.uint8(1) << base
    mixed = strain.copy()
    for i, donors in zip(draws.mixed, draws.donors):
        for j in donors:
            mixed[i] |= strain[j]
    is_n = np.zeros((n, 4, -(-L // 32)), dtype=np.uint32)
    generate._n_sites(is_n, rng, L, cfg["n_share"])
    partial = np.zeros(L, dtype=bool)
    partial[rng.choice(L, size=min(cfg["partial_columns"], L // 8), replace=False)] = True
    return SimpleNamespace(draws=draws, root=root_code, strain=strain, mixed=mixed,
                           is_n=generate.planes_to_nibbles(is_n, L) == 15, partial=partial)
