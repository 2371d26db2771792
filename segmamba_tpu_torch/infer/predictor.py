"""Predictor: mirror-TTA sliding-window prediction + inverse preprocessing.

Port of ``segmamba_tpu/infer/predictor.py`` (the reference SegMamba's
light_training/prediction.py), NCDHW:
- ``maybe_mirror_and_predict``: the sliding-window prediction averaged over
  the volume flipped along every subset of the mirror axes (:110-159);
- ``predict_raw_probability``: order-1 resample of the logits back to the
  shape before resampling (:35-63);
- ``predict_noncrop_probability``: paste into the frame before cropping at
  the stored box (:66-108);
- ``largest_connected_component`` and ``save_to_nii`` (:17-27, :208-226).

Volumes are ``(1, C, Z, Y, X)`` tensors on the model's device; the inverse
steps run on the host in numpy (per case, shape-dynamic, IO-bound).
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch
from scipy import ndimage

from segmamba_tpu_torch.data.nifti import write_nifti


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class Predictor:
    def __init__(self, window_infer, mirror_axes=(0, 1, 2)):
        self.window_infer = window_infer
        self.mirror_axes = tuple(mirror_axes) if mirror_axes else ()

    def maybe_mirror_and_predict(self, x, predictor_fn, num_classes=None):
        """x: (1, C, Z, Y, X). Returns the averaged float32 logits
        (1, K, Z, Y, X): the plain prediction, then every combination of
        the mirror axes in ``itertools.combinations`` order, summed and
        divided by their number. ``num_classes`` is the JAX signature's and
        is not needed."""
        with torch.no_grad():
            pred = self.window_infer(x, predictor_fn)
            n = 1
            for r in range(1, len(self.mirror_axes) + 1):
                for combo in itertools.combinations(self.mirror_axes, r):
                    dims = tuple(a + 2 for a in combo)
                    out = self.window_infer(x.flip(dims), predictor_fn)
                    pred = pred + out.flip(dims)
                    n += 1
            return pred / n

    @staticmethod
    def predict_raw_probability(logits, properties):
        """(1, K, Z, Y, X) or (K, Z, Y, X) tensor or array -> (K, z0, y0, x0)
        float32 numpy, linearly resampled to
        ``shape_after_cropping_before_resample`` (torch trilinear ~ order-1
        spline)."""
        arr = _numpy(logits).astype(np.float32)
        if arr.ndim == 5:
            arr = arr[0]
        target = tuple(int(s) for s in
                       properties["shape_after_cropping_before_resample"])
        if arr.shape[1:] == target:
            return arr
        zoom = [t / s for t, s in zip(target, arr.shape[1:])]
        out = np.stack([
            ndimage.zoom(arr[c], zoom, order=1, mode="nearest",
                         grid_mode=True)
            for c in range(arr.shape[0])], axis=0)
        return out.astype(np.float32)

    @staticmethod
    def predict_noncrop_probability(pred, properties, fill=0.0):
        """Paste (K or 1, z, y, x) into the pre-crop volume at the stored
        box."""
        pred = _numpy(pred)
        full_shape = tuple(int(s) for s in properties["shape_before_cropping"])
        bbox = properties["bbox_used_for_cropping"]
        out = np.full((pred.shape[0],) + full_shape, fill, pred.dtype)
        sl = tuple(slice(b[0], b[1]) for b in bbox)
        out[(slice(None),) + sl] = pred
        return out

    @staticmethod
    def largest_connected_component(seg_binary):
        """Keep only the largest connected component."""
        labeled, n = ndimage.label(seg_binary)
        if n <= 1:
            return seg_binary
        sizes = ndimage.sum_labels(np.ones_like(labeled), labeled,
                                   index=np.arange(1, n + 1))
        keep = 1 + int(np.argmax(sizes))
        return (labeled == keep).astype(seg_binary.dtype)

    @staticmethod
    def save_to_nii(seg, properties, output_dir, name=None, spacing=None,
                    postprocess_largest_cc=False):
        """Write (z, y, x) labels to ``<output_dir>/<name>.nii.gz``."""
        seg = _numpy(seg)
        if seg.ndim == 4 and seg.shape[0] == 1:
            seg = seg[0]
        if postprocess_largest_cc:
            seg = Predictor.largest_connected_component(seg)
        name = name or properties.get("name", "prediction")
        spacing = spacing or tuple(properties.get("spacing", (1.0, 1.0, 1.0)))
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"{name}.nii.gz")
        write_nifti(path, seg.astype(np.uint8), spacing=spacing)
        return path
