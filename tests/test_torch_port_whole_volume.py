"""Port whole-volume inference vs the JAX package, on the CPU.

The shape helpers (``num_slices_for_shape``, ``pad_to_multiple``,
``nonzero_bbox``) must equal JAX's exactly. The single-shot forward and its
mirror TTA run the port's ``SegMamba`` against JAX ``SegMamba(scan_impl=
"chunked")`` at the tiny config of tests/test_torch_port_model.py, params
through the bridge (``convert_segmamba_state_dict``), float32 at rtol 2e-3,
atol 1e-2 * max|ref| (the model test's tier). The crop boxes here give
stage slice counts below d_conv - 1 = 3, where JAX's directional conv is
wrong; "chunked" runs the slice orientation by itself and is right. Three
JAX compiles: the 32^3 forward, the ragged crop's forward and its TTA.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.infer import whole_volume as jwv
from segmamba_tpu.models import SegMamba as JSegMamba
from segmamba_tpu.utils.torch_convert import convert_segmamba_state_dict
from segmamba_tpu_torch.infer import whole_volume as twv
from segmamba_tpu_torch.models import SegMamba

CFG = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
           feat_size=(4, 8, 16, 32), hidden_size=64,
           num_slices_list=(8, 4, 2, 1))
# a (20, 40, 44) frame whose nonzero voxels span z 1..18, y 3..37 and
# x 30..41: the box is the whole z (20, padded to 32), the whole y (35
# rounds to 48, more than the frame: 40, padded to 48) and x [28, 44)
# (12 rounds to 16 and slides back inside the frame); crop (20, 40, 16),
# padded (32, 48, 16), so z and y get trailing padding
RAGGED = (20, 40, 44)
RAGGED_NZ = (slice(1, 19), slice(3, 38), slice(30, 42))


def _tol(want):
    return dict(rtol=2e-3, atol=1e-2 * np.abs(want).max())


def _to_jax(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _from_jax(y):
    return np.moveaxis(np.asarray(y), -1, 1)


@pytest.fixture(scope="module")
def pair():
    model = SegMamba(generator=torch.Generator().manual_seed(0), **CFG)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_segmamba_state_dict(model.state_dict(),
                                                 depths=CFG["depths"]))
    return model.eval(), JSegMamba(scan_impl="chunked", **CFG), params


@pytest.fixture(scope="module")
def ragged():
    rng = np.random.default_rng(1)
    x = np.zeros((1, 2, *RAGGED), np.float32)
    x[(slice(None), slice(None)) + RAGGED_NZ] = rng.standard_normal(
        (1, 2) + tuple(s.stop - s.start for s in RAGGED_NZ))
    return x


@pytest.mark.parametrize("shape", [
    (32, 32, 32), (160, 192, 160), (144, 176, 144), (20, 32, 16), (8, 8, 8),
    (16, 64, 64)])
def test_num_slices_for_shape_matches_jax(shape):
    assert twv.num_slices_for_shape(shape) == jwv.num_slices_for_shape(shape)


@pytest.mark.parametrize("shape", [(20, 40, 44), (32, 16, 48), (1, 17, 33),
                                   (150, 180, 150)])
def test_pad_to_multiple_matches_jax(shape):
    x = np.random.default_rng(2).standard_normal((1, 2, *shape)).astype(
        np.float32)
    got, size = twv.pad_to_multiple(torch.from_numpy(x))
    want, jsize = jwv.pad_to_multiple(_to_jax(x))
    assert size == jsize == shape
    np.testing.assert_array_equal(got.numpy(), _from_jax(want))


@pytest.mark.parametrize("frame,nz", [
    (RAGGED, RAGGED_NZ),                                   # slides in x
    ((40, 36, 44), (slice(0, 40), slice(0, 36), slice(0, 44))),  # full
    ((40, 36, 44), (slice(3, 4), slice(35, 36), slice(0, 1))),   # corners
    ((155, 240, 240), (slice(10, 140), slice(30, 210), slice(40, 190))),
    ((33, 33, 33), (slice(30, 33), slice(0, 2), slice(16, 17))),
])
def test_nonzero_bbox_matches_jax(frame, nz):
    x = np.zeros((1, 2, *frame), np.float32)
    x[(slice(None), 1) + nz] = -1.5
    box = twv.nonzero_bbox(torch.from_numpy(x))
    assert box == jwv.nonzero_bbox(_to_jax(x))
    assert all(hi - lo == min(d, -(-(s.stop - s.start) // 16) * 16)
               for (lo, hi), d, s in zip(box, frame, nz))


def test_nonzero_bbox_all_zero_is_the_frame():
    x = np.zeros((1, 3, 20, 40, 44), np.float32)
    assert (twv.nonzero_bbox(torch.from_numpy(x))
            == jwv.nonzero_bbox(_to_jax(x)) == ((0, 20), (0, 40), (0, 44)))


def test_whole_volume_exact_cube_matches_jax(pair):
    model, jm, params = pair
    x = np.random.default_rng(0).standard_normal((1, 2, 32, 32, 32)).astype(
        np.float32)
    want = _from_jax(jwv.whole_volume_inference(jm, params, _to_jax(x)))
    got = twv.whole_volume_inference(model, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))
    assert model.num_slices_list == CFG["num_slices_list"]


def _outside(box, frame):
    mask = np.ones(frame, bool)
    mask[tuple(slice(lo, hi) for lo, hi in box)] = False
    return mask


def test_whole_volume_ragged_crop_matches_jax(pair, ragged):
    model, jm, params = pair
    box = twv.nonzero_bbox(torch.from_numpy(ragged))
    assert box == ((0, 20), (0, 40), (28, 44))
    want = _from_jax(jwv.whole_volume_inference(jm, params,
                                                _to_jax(ragged)))
    got = twv.whole_volume_inference(model, torch.from_numpy(ragged)).numpy()
    assert got.shape == want.shape == (1, 3, *RAGGED)
    np.testing.assert_allclose(got, want, **_tol(want))
    out = _outside(box, RAGGED)
    np.testing.assert_array_equal(got[0][:, out], want[0][:, out])
    assert (got[0, 0][out] == 20.0).all() and (got[0, 1:][:, out] == 0).all()
    assert model.num_slices_list == CFG["num_slices_list"]


def test_whole_volume_tta_matches_jax(pair, ragged):
    """Flip-then-pad on a crop with trailing padding on z and y."""
    model, jm, params = pair
    want = _from_jax(jwv.whole_volume_tta(jm, params, _to_jax(ragged),
                                          mirror_axes=(0, 1, 2)))
    got = twv.whole_volume_tta(model, torch.from_numpy(ragged),
                               mirror_axes=(0, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))
    out = _outside(twv.nonzero_bbox(torch.from_numpy(ragged)), RAGGED)
    np.testing.assert_array_equal(got[0][:, out], want[0][:, out])
    # the mean of the 8 flips is not the plain forward
    single = twv.whole_volume_inference(model, torch.from_numpy(ragged))
    assert np.abs(got - single.numpy()).max() > 1e-3
    assert model.num_slices_list == CFG["num_slices_list"]


def test_whole_volume_predictor_is_the_tta(pair, ragged):
    model, _, _ = pair
    x = torch.from_numpy(ragged)
    pred = twv.WholeVolumePredictor(model, mirror_axes=(1,))
    torch.testing.assert_close(pred.maybe_mirror_and_predict(x),
                               twv.whole_volume_tta(model, x, (1,)),
                               rtol=0, atol=0)
    torch.testing.assert_close(pred(x), twv.whole_volume_inference(model, x),
                               rtol=0, atol=0)


def test_flip_combos_follow_jax_bit_order():
    assert twv._flip_combos((0, 1, 2)) == [
        (), (0,), (1,), (0, 1), (2,), (0, 2), (1, 2), (0, 1, 2)]
    assert twv._flip_combos(()) == [()]


def test_slices_restored_when_forward_raises(pair):
    model, _, _ = pair
    with pytest.raises(ValueError, match="must divide"):
        with model.slices((7, 4, 2, 1)):
            assert model.num_slices_list == (7, 4, 2, 1)
            model(torch.zeros(1, 2, 32, 32, 32))
    assert model.num_slices_list == CFG["num_slices_list"]
    with pytest.raises(ValueError, match="slice counts"):
        with model.slices((8, 4)):
            pass
    assert model.num_slices_list == CFG["num_slices_list"]


def test_uncropped_matches_cropped_frame_without_background(pair):
    """``crop_to_nonzero=False`` runs the padded frame (no paste)."""
    model, _, _ = pair
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 2, 20, 24, 16)).astype(np.float32))
    got = twv.whole_volume_inference(model, x, crop_to_nonzero=False)
    padded, _ = twv.pad_to_multiple(x)
    with torch.no_grad(), model.slices(twv.num_slices_for_shape(
            padded.shape[2:])):
        want = model(padded)[:, :, :20, :24, :16]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
