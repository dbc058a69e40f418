"""The benchmark's copied generator and dates equal the program's originals."""

import os
import sys

import numpy as np
import pytest

from benchmark import generate

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("n,length,cluster,max_mut,partial", [
    (50, 1000, 6, 90, 2048), (64, 3333, 7, 10, 100), (100, 20000, 21, 90, 2048),
    (33, 29903, 21, 10, 2048), (21, 64, 21, 90, 0)])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_make_clustered_equals_the_ports(n, length, cluster, max_mut, partial, seed):
    from tracs_tpu_torch.experiments.workload import make_clustered

    ours = generate.make_clustered(n, length, cluster_size=cluster, max_mut=max_mut,
                                   n_partial_cols=partial, n_share=0.14, seed=seed)
    theirs = make_clustered(n, length, cluster_size=cluster, max_mut=max_mut,
                            n_partial_cols=partial, seed=seed).planes
    assert np.array_equal(ours, theirs)


def test_n_share_is_a_parameter():
    none = generate.random_planes(4, 4096, 0.0, 1)
    all4 = none[:, 0] & none[:, 1] & none[:, 2] & none[:, 3]
    assert not all4.any()
    some = generate.random_planes(4, 4096, 0.5, 1)
    share = np.unpackbits((some[:, 0] & some[:, 1] & some[:, 2] & some[:, 3]).view(np.uint8)).mean()
    assert 0.45 < share < 0.55


@pytest.mark.parametrize("n,cluster,seed", [(50, 6, 0), (100, 21, 2**31 + 9), (7, 3, 12)])
def test_write_dates_equals_chip_smokes(tmp_path, n, cluster, seed):
    sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.write_dates(str(tmp_path / "a.csv"), n, cluster, seed)
    generate.write_dates(str(tmp_path / "b.csv"), n, cluster, seed)
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
