"""Port sliding-window inference vs the JAX package, on the CPU.

Both frameworks blend one fixed numpy-defined per-voxel affine predictor
(a channel mix plus a position-dependent bias over the window, so mirror
TTA changes the result) on a 40x36x44 two-channel volume, roi 16^3,
overlap 0.5, gaussian blending, bucket 32. Tolerance: rtol = atol = 1e-5
(float32 accumulation in a different order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segmamba_tpu.infer import sliding_window as jsw
from segmamba_tpu_torch.infer import sliding_window as tsw

ROI = (16, 16, 16)
K = 3


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((40, 36, 44, 2)).astype(np.float32)
    W = rng.standard_normal((2, K)).astype(np.float32)
    ramp = rng.standard_normal(ROI + (K,)).astype(np.float32)
    return vol, W, ramp


def _jax_predictor(W, ramp):
    Wj, rj = jnp.asarray(W), jnp.asarray(ramp)
    return lambda w: jnp.einsum("bzyxc,ck->bzyxk", w, Wj) + rj


def _torch_predictor(W, ramp):
    Wt = torch.from_numpy(W)
    rt = torch.from_numpy(np.moveaxis(ramp, -1, 0))          # (K, *roi)
    return lambda w: torch.einsum("bczyx,ck->bkzyx", w, Wt) + rt


@pytest.mark.parametrize("sw_batch", [1, 2])
@pytest.mark.parametrize("tta", [None, (0, 1, 2)])
def test_sliding_window_matches_jax(case, sw_batch, tta):
    vol, W, ramp = case
    want = jsw.sliding_window_inference(
        jnp.asarray(vol[None]), ROI, _jax_predictor(W, ramp), overlap=0.5,
        sw_batch_size=sw_batch, num_classes=K, tta_flips=tta)
    got = tsw.sliding_window_inference(
        torch.from_numpy(np.moveaxis(vol, -1, 0)[None].copy()), ROI,
        _torch_predictor(W, ramp), overlap=0.5, sw_batch_size=sw_batch,
        tta_flips=tta)
    assert got.shape == (1, K, 40, 36, 44) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("image,roi,overlap", [
    ((64, 64, 64), (16, 16, 16), 0.5),
    ((160, 192, 160), (128, 128, 128), 0.5),
    ((40, 36, 44), (16, 16, 16), 0.25),
    ((12, 40, 20), (16, 16, 16), 0.5),
])
def test_scan_starts_match_jax(image, roi, overlap):
    np.testing.assert_array_equal(tsw._scan_starts(image, roi, overlap),
                                  jsw._scan_starts(image, roi, overlap))


@pytest.mark.parametrize("roi", [(16, 16, 16), (128, 128, 128), (8, 12, 5)])
def test_gaussian_importance_map_matches_jax(roi):
    np.testing.assert_array_equal(tsw.gaussian_importance_map(roi),
                                  jsw.gaussian_importance_map(roi))


def test_bench_case_has_eight_windows():
    """150x180x150 buckets to 160x192x160: 2 x 2 x 2 windows of 128^3."""
    assert len(tsw._scan_starts((160, 192, 160), (128,) * 3, 0.5)) == 8


def test_batch_not_one_raises():
    with pytest.raises(ValueError, match="batch size 1"):
        tsw.sliding_window_inference(torch.zeros(2, 1, 16, 16, 16), ROI,
                                     lambda w: w)
