"""Port ``Predictor`` vs the JAX package's, on the CPU.

``maybe_mirror_and_predict`` blends the numpy-defined per-voxel affine
predictor of tests/test_torch_port_sliding_window.py (a channel mix plus a
position-dependent bias over the window, so every flip changes the result)
through both frameworks' sliding windows, rtol = atol = 1e-5. The inverse
steps (``predict_raw_probability`` on an anisotropic target,
``predict_noncrop_probability``, ``largest_connected_component``,
``save_to_nii``) are numpy on both sides and must agree to float32
rounding or exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segmamba_tpu.data.nifti import read_nifti as j_read_nifti
from segmamba_tpu.infer import Predictor as JPredictor
from segmamba_tpu.infer import SlidingWindowInferer as JInferer
from segmamba_tpu_torch.infer import Predictor, SlidingWindowInferer

ROI = (16, 16, 16)
K = 3


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((30, 36, 20, 2)).astype(np.float32)
    W = rng.standard_normal((2, K)).astype(np.float32)
    ramp = rng.standard_normal(ROI + (K,)).astype(np.float32)
    return vol, W, ramp


@pytest.mark.parametrize("mirror", [(0, 1, 2), (2,), (0, 2), ()])
def test_maybe_mirror_and_predict_matches_jax(case, mirror):
    vol, W, ramp = case
    Wj, rj = jnp.asarray(W), jnp.asarray(ramp)
    jpred = JPredictor(JInferer(ROI, sw_batch_size=2, overlap=0.5),
                       mirror_axes=mirror)
    want = jpred.maybe_mirror_and_predict(
        jnp.asarray(vol[None]),
        lambda w: jnp.einsum("bzyxc,ck->bzyxk", w, Wj) + rj, num_classes=K)
    Wt = torch.from_numpy(W)
    rt = torch.from_numpy(np.moveaxis(ramp, -1, 0).copy())
    pred = Predictor(SlidingWindowInferer(ROI, sw_batch_size=2, overlap=0.5),
                     mirror_axes=mirror)
    got = pred.maybe_mirror_and_predict(
        torch.from_numpy(np.moveaxis(vol, -1, 0)[None].copy()),
        lambda w: torch.einsum("bczyx,ck->bkzyx", w, Wt) + rt)
    assert got.shape == (1, K, 30, 36, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", [(30, 36, 20), (12, 50, 41), (45, 36, 7)])
def test_predict_raw_probability_matches_jax(target):
    logits = np.random.default_rng(1).standard_normal(
        (1, 30, 36, 20, K)).astype(np.float32)
    props = {"shape_after_cropping_before_resample": target}
    want = JPredictor.predict_raw_probability(logits, props)
    t = torch.from_numpy(np.moveaxis(logits, -1, 1).copy())
    for given in (t, t[0], t.numpy()):
        got = Predictor.predict_raw_probability(given, props)
        assert got.shape == (K, *target) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_predict_noncrop_probability_matches_jax():
    pred = np.random.default_rng(2).integers(0, 4, (1, 9, 12, 7)).astype(
        np.int64)
    props = {"shape_before_cropping": (20, 30, 25),
             "bbox_used_for_cropping": [[3, 12], [10, 22], [18, 25]]}
    want = JPredictor.predict_noncrop_probability(pred, props)
    got = Predictor.predict_noncrop_probability(torch.from_numpy(pred), props)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        Predictor.predict_noncrop_probability(pred, props, fill=-1),
        JPredictor.predict_noncrop_probability(pred, props, fill=-1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_largest_connected_component_matches_jax(seed):
    seg = (np.random.default_rng(seed).random((16, 18, 14)) > 0.7).astype(
        np.uint8)
    got = Predictor.largest_connected_component(seg)
    np.testing.assert_array_equal(
        got, JPredictor.largest_connected_component(seg))
    assert got.sum() < seg.sum()
    one = np.zeros((8, 8, 8), np.uint8)
    one[2:4, 2:5, 1:3] = 1
    np.testing.assert_array_equal(Predictor.largest_connected_component(one),
                                  one)


def test_save_to_nii_reads_back_under_jax(tmp_path):
    seg = np.zeros((1, 10, 12, 8), np.int64)
    seg[0, 2:5, 3:9, 1:4] = 2
    seg[0, 7:9, 1:2, 5:7] = 3
    props = {"name": "case_7", "spacing": (1.0, 0.8, 2.5)}
    path = Predictor.save_to_nii(seg, props, str(tmp_path / "out"),
                                 postprocess_largest_cc=False)
    assert path.endswith("case_7.nii.gz")
    img = j_read_nifti(path, with_meta=True)
    np.testing.assert_array_equal(img.array, seg[0].astype(np.uint8))
    assert img.spacing == pytest.approx((1.0, 0.8, 2.5))
    path = Predictor.save_to_nii(seg, props, str(tmp_path / "cc"),
                                 postprocess_largest_cc=True)
    np.testing.assert_array_equal(
        j_read_nifti(path),
        JPredictor.largest_connected_component(seg[0]).astype(np.uint8))
