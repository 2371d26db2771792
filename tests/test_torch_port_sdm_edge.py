"""The port's SDM/edge dataset (``segmamba_tpu_torch.data.sdm_edge``)
against the JAX package's, on the CPU: every function on a seeded label
map (nested random ellipsoids, BraTS labels 1-3) and ``SdmEdgeDataset`` /
``precompute_sdm`` on synthetic cases give identical arrays and files.

CPU time: about 2 s.
"""

import os

import numpy as np
import pytest

from segmamba_tpu.data import sdm_edge as J
from segmamba_tpu_torch.data import sdm_edge as T
from segmamba_tpu_torch.data import unpack_dataset
from segmamba_tpu_torch.data.synthetic import write_synthetic_cases


def _labels(seed, shape=(18, 22, 20)):
    """Nested ellipsoids at seeded centres and radii: 2 outside, then 1,
    then 3."""
    rng = np.random.default_rng(seed)
    grid = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    centre = [rng.uniform(0.35, 0.65) * s for s in shape]
    radii = rng.uniform(3.0, 7.0, 3)
    d = np.sqrt(sum(((g - c) / r) ** 2 for g, c, r in zip(grid, centre,
                                                           radii)))
    lab = np.zeros(shape, np.int32)
    lab[d < 1.0] = 2
    lab[d < 0.6] = 1
    lab[d < 0.3] = 3
    return lab


@pytest.mark.parametrize("seed", [0, 1])
def test_functions_match_jax(seed):
    lab = _labels(seed)
    regions = T.convert_labels_regions(lab)
    np.testing.assert_array_equal(regions, J.convert_labels_regions(lab))
    np.testing.assert_array_equal(T.edge_map(regions[None]),
                                  J.edge_map(regions[None]))
    np.testing.assert_array_equal(T.edge_map(lab[0] > 0),
                                  J.edge_map(lab[0] > 0))     # 2-D
    np.testing.assert_array_equal(T.compute_sdf(regions[None]),
                                  J.compute_sdf(regions[None]))
    np.testing.assert_array_equal(T.sdm_target(lab), J.sdm_target(lab))


def test_dataset_and_precompute_match_jax(tmp_path):
    folder = str(tmp_path / "cases")
    paths = write_synthetic_cases(folder, 2, (16, 20, 18), labels=(1, 2, 3),
                                  seed=3)
    unpack_dataset(folder)
    got = T.precompute_sdm(paths, str(tmp_path / "port_sdm"))
    want = J.precompute_sdm(paths, str(tmp_path / "jax_sdm"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.load(a), np.load(b))
    tds = T.SdmEdgeDataset(paths, str(tmp_path / "port_sdm"))
    jds = J.SdmEdgeDataset(paths, str(tmp_path / "jax_sdm"))
    assert len(tds) == len(jds) == 2
    for i in range(2):
        a, b = tds[i], jds[i]
        assert a["seg"].shape == (4, 16, 20, 18)
        np.testing.assert_array_equal(a["seg"], b["seg"])
        np.testing.assert_array_equal(a["data"], b["data"])
