"""Whole-volume single-shot inference, NCDHW: no sliding window.

Port of ``segmamba_tpu/infer/whole_volume.py`` (``num_slices_for_shape``,
``pad_to_multiple``, ``nonzero_bbox``, ``whole_volume_inference``,
``whole_volume_tta``, ``WholeVolumePredictor``). The selective scan is
linear in the sequence length, so the whole padded case (1.15 M stage-0
tokens for the uncropped 155x240x240 BraTS frame) runs as one forward. The
encoder downsamples 16x, so the volume is padded on the trailing side to
multiples of 16, and the tri-oriented Mamba's slice counts come from the
padded depth at each stage (at 128^3 the reference's 64/32/16/8); they
hold no parameter, so the sliding-window checkpoint runs here unchanged.

``crop_to_nonzero`` first restricts the forward to the nonzero box (its
extents rounded up to 16, the box slid to stay inside the frame) and
pastes the logits back into a float32 frame whose class 0 is pinned at
``background_logit`` outside the box, the semantics the Predictor's
inverse crop gives a sliding-window segmentation.

Mirror TTA is the mean over the 2^len(axes) flips of the cropped volume,
each flipped volume padded on its trailing side, run, un-padded and
un-flipped, accumulated in float32: flip-then-pad, which JAX builds in one
program from ``rev`` and ``roll``. Each forward is an eager call, so there
is nothing to compile and nothing to cache.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from segmamba_tpu_torch.infer.predictor import Predictor


def num_slices_for_shape(spatial_shape, n_stages=4):
    """Per-stage slice counts = depth-axis size after each downsample."""
    d = spatial_shape[0]
    return tuple(max(1, d // (2 ** (i + 1))) for i in range(n_stages))


def pad_to_multiple(volume, multiple=16):
    """Zero-pad (1, C, Z, Y, X) on the trailing side of each spatial axis up
    to a multiple; returns (padded, (Z, Y, X))."""
    Z, Y, X = volume.shape[2:]
    tz, ty, tx = (int(math.ceil(s / multiple) * multiple) for s in (Z, Y, X))
    return F.pad(volume, (0, tx - X, 0, ty - Y, 0, tz - Z)), (Z, Y, X)


def nonzero_bbox(volume, multiple=16, margin=0):
    """Bounding box of the nonzero voxels of (1, C, Z, Y, X) (any channel),
    grown by ``margin``, each extent rounded up to ``multiple`` and the box
    slid to stay inside the frame. An axis with no nonzero voxel keeps the
    whole frame. Returns ((z0, z1), (y0, y1), (x0, x1))."""
    mask = (volume[0].abs() > 0).any(0).cpu().numpy()
    bounds = []
    for ax, dim in enumerate(mask.shape):
        proj = mask.any(axis=tuple(d for d in range(3) if d != ax))
        nz = np.flatnonzero(proj)
        if nz.size == 0:
            bounds.append((0, dim))
            continue
        lo = max(0, int(nz[0]) - margin)
        hi = min(dim, int(nz[-1]) + 1 + margin)
        ext = min(dim, int(math.ceil((hi - lo) / multiple) * multiple))
        lo = max(0, min(lo, dim - ext))
        bounds.append((lo, lo + ext))
    return tuple(bounds)


def _crop(volume, multiple, crop_to_nonzero):
    """(the box's view of ``volume``, box); box None when it is the frame."""
    if not crop_to_nonzero:
        return volume, None
    box = nonzero_bbox(volume, multiple)
    if tuple(hi - lo for lo, hi in box) == tuple(volume.shape[2:]):
        return volume, None
    (z0, z1), (y0, y1), (x0, x1) = box
    return volume[:, :, z0:z1, y0:y1, x0:x1], box


def _forward(model, volume, multiple):
    """Logits (1, K, Z, Y, X) float32 of one padded forward, the slice
    counts set from the padded depth."""
    padded, (Z, Y, X) = pad_to_multiple(volume, multiple)
    with model.slices(num_slices_for_shape(padded.shape[2:])):
        return model(padded)[:, :, :Z, :Y, :X].float()


def _paste(logits, frame, box, background_logit):
    """Logits of the box in a float32 frame of (Z0, Y0, X0) whose class 0 is
    ``background_logit`` (the others 0) outside the box."""
    if box is None:
        return logits
    full = logits.new_zeros((1, logits.shape[1], *frame))
    full[:, 0] = background_logit
    (z0, z1), (y0, y1), (x0, x1) = box
    full[:, :, z0:z1, y0:y1, x0:x1] = logits
    return full


def whole_volume_inference(model, volume, multiple=16, crop_to_nonzero=True,
                           background_logit=20.0):
    """One forward of ``model`` over the whole (1, C, Z, Y, X) ``volume``.

    Returns float32 logits (1, K, Z, Y, X) at the volume's size."""
    with torch.no_grad():
        vol, box = _crop(volume, multiple, crop_to_nonzero)
        return _paste(_forward(model, vol, multiple), volume.shape[2:], box,
                      background_logit)


def _flip_combos(axes):
    """Flip combinations in JAX's order: combination i flips ``axes[k]``
    where bit k of i is set."""
    return [tuple(a for k, a in enumerate(axes) if (i >> k) & 1)
            for i in range(2 ** len(axes))]


def whole_volume_tta(model, volume, mirror_axes=(0, 1, 2), multiple=16,
                     crop_to_nonzero=True, background_logit=20.0):
    """Mirror-TTA mean of whole-volume forwards; the crop, pad and paste of
    ``whole_volume_inference``. ``mirror_axes`` are spatial (0=Z, 1=Y,
    2=X), as the Predictor's and the predict CLI's ``--mirror``."""
    axes = tuple(mirror_axes) if mirror_axes else ()
    with torch.no_grad():
        vol, box = _crop(volume, multiple, crop_to_nonzero)
        combos = _flip_combos(axes)
        acc = None
        for combo in combos:
            dims = tuple(a + 2 for a in combo)
            out = _forward(model, vol.flip(dims) if dims else vol, multiple)
            out = out.flip(dims) if dims else out
            acc = out if acc is None else acc.add_(out)
        return _paste(acc / len(combos), volume.shape[2:], box,
                      background_logit)


class WholeVolumePredictor:
    """The Predictor's surface (``maybe_mirror_and_predict`` and the inverse
    steps) with one forward per (flipped) volume in place of the sliding
    window."""

    predict_raw_probability = staticmethod(Predictor.predict_raw_probability)
    predict_noncrop_probability = staticmethod(
        Predictor.predict_noncrop_probability)
    largest_connected_component = staticmethod(
        Predictor.largest_connected_component)
    save_to_nii = staticmethod(Predictor.save_to_nii)

    def __init__(self, model, mirror_axes=(0, 1, 2), multiple=16):
        self.model = model
        self.mirror_axes = tuple(mirror_axes) if mirror_axes else ()
        self.multiple = multiple

    def __call__(self, x):
        return whole_volume_inference(self.model, x, self.multiple)

    def maybe_mirror_and_predict(self, x, predictor_fn=None,
                                 num_classes=None):
        """Mean over the mirror flips of whole-volume forwards
        (``whole_volume_tta``); ``predictor_fn`` and ``num_classes`` are
        the Predictor's arguments and are not used."""
        return whole_volume_tta(self.model, x, mirror_axes=self.mirror_axes,
                                multiple=self.multiple)
