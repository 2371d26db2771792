"""Gaussian-blended sliding-window inference, NCDHW.

Port of ``segmamba_tpu/infer/sliding_window.py`` (``_scan_starts``,
``gaussian_importance_map``, ``sliding_window_inference``,
``SlidingWindowInferer``, ``_tta_predict``), the semantics of the MONAI
inferer the reference evaluates with: the volume is zero-padded up to a
multiple of ``bucket`` (and to at least the roi), windows start on the
overlap grid, each window's logits are weighted by a gaussian importance
map and accumulated into float32 ``out``/``cnt`` volumes, and the blend is
``out / cnt`` cropped back to the case's size.

The window loop is plain Python over window batches, gathering by slicing
on the volume's device. The JAX package's host-loop split and its HTTP-413
fallback exist only for its remote-compile relay and are not ported.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _scan_starts(image_size, roi_size, overlap):
    """Window start offsets, (n_windows, 3) int32 (MONAI
    ``_get_scan_interval`` + ``dense_patch_slices``)."""
    starts = []
    for im, roi in zip(image_size, roi_size):
        if roi >= im:
            starts.append([0])
            continue
        interval = max(1, int(roi * (1 - overlap)))
        n = int(math.ceil((im - roi) / interval)) + 1
        starts.append(sorted({min(i * interval, im - roi) for i in range(n)}))
    grid = np.stack(np.meshgrid(*starts, indexing="ij"), -1).reshape(-1, 3)
    return grid.astype(np.int32)


def gaussian_importance_map(roi_size, sigma_scale=0.125, dtype=np.float32):
    """Separable gaussian, peak 1, clamped at max(min, 1e-3) so no weight is
    zero (MONAI ``compute_importance_map``)."""
    maps = []
    for s in roi_size:
        center = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-3)
        x = np.arange(s, dtype=np.float64)
        maps.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    m = maps[0][:, None, None] * maps[1][None, :, None] * maps[2][None, None, :]
    m = np.maximum(m, max(float(m.min()), 1e-3))
    return (m / m.max()).astype(dtype)


def _flip_combos(tta_flips):
    """All flip combinations of the given spatial axes, identity first."""
    combos = [()]
    for r in range(1, len(tta_flips) + 1):
        combos.extend(itertools.combinations(tta_flips, r))
    return combos


def _tta_predict(predictor, wins, tta_flips):
    """Mean over mirror flips of ``unflip(predictor(flip(wins)))``, per
    window (the reference's 8-combination mirror TTA). ``wins`` is
    (sw, C, rz, ry, rx); spatial axes (0, 1, 2) are dims 2..4."""
    combos = _flip_combos(tta_flips)
    acc = None
    for c in combos:
        dims = tuple(a + 2 for a in c)
        w = wins.flip(dims) if dims else wins
        out = predictor(w).float()
        out = out.flip(dims) if dims else out
        acc = out if acc is None else acc + out
    return acc / len(combos)


def sliding_window_inference(volume, roi_size, predictor, overlap=0.5,
                             sw_batch_size=2, bucket=32, mode="gaussian",
                             compute_dtype=None, tta_flips=None):
    """Gaussian-blended sliding-window prediction.

    Args:
      volume:    (1, C, Z, Y, X) or (C, Z, Y, X) tensor; the windows are cut
                 on its device.
      roi_size:  window size triple (the BraTS recipe uses 128^3).
      predictor: callable (B, C, *roi) -> (B, K, *roi) logits.
      bucket:    the volume is zero-padded up to multiples of this.
      mode:      "gaussian" or "constant" blending weights.
      compute_dtype: optional dtype the windows are cast to before the
                 predictor (blending stays float32).
      tta_flips: optional spatial axes (subset of (0, 1, 2)) for
                 window-level mirror TTA (see ``_tta_predict``).
    Returns:
      (1, K, Z, Y, X) float32 blended logits ((K, Z, Y, X) for a 4-d input).
    """
    squeeze = volume.dim() == 4
    if squeeze:
        volume = volume[None]
    if volume.shape[0] != 1:
        raise ValueError(
            "sliding_window_inference expects batch size 1, got volume "
            f"shape {tuple(volume.shape)}; run cases one at a time")
    if mode not in ("gaussian", "constant"):
        raise ValueError(f"unknown blend mode {mode!r}")
    _, C, Z, Y, X = volume.shape
    roi_size = tuple(int(r) for r in roi_size)
    rz, ry, rx = roi_size

    def padded(dim, roi):
        tgt = max(dim, roi)
        return int(math.ceil(tgt / bucket) * bucket) if bucket else tgt

    pz, py, px = padded(Z, rz), padded(Y, ry), padded(X, rx)
    vol = F.pad(volume[0].float(), (0, px - X, 0, py - Y, 0, pz - Z))
    if compute_dtype is not None:
        vol = vol.to(compute_dtype)

    starts = _scan_starts((pz, py, px), roi_size, overlap)
    sw = max(1, sw_batch_size)
    imp = torch.from_numpy(
        gaussian_importance_map(roi_size) if mode == "gaussian"
        else np.ones(roi_size, np.float32)).to(vol.device)
    out = cnt = None
    for g in range(0, len(starts), sw):
        group = starts[g:g + sw]
        wins = torch.stack([vol[:, s[0]:s[0] + rz, s[1]:s[1] + ry,
                                s[2]:s[2] + rx] for s in group])
        if tta_flips:
            logits = _tta_predict(predictor, wins, tuple(tta_flips))
        else:
            logits = predictor(wins).float()
        if out is None:
            out = torch.zeros((logits.shape[1], pz, py, px),
                              dtype=torch.float32, device=vol.device)
            cnt = torch.zeros((1, pz, py, px), dtype=torch.float32,
                              device=vol.device)
        for i, s in enumerate(group):
            sl = (slice(None), slice(s[0], s[0] + rz),
                  slice(s[1], s[1] + ry), slice(s[2], s[2] + rx))
            out[sl] += logits[i] * imp
            cnt[sl] += imp
    blended = (out / torch.clamp_min(cnt, 1e-8))[:, :Z, :Y, :X]
    return blended if squeeze else blended[None]


class SlidingWindowInferer:
    """Config wrapper mirroring the reference's inferer construction."""

    def __init__(self, roi_size, sw_batch_size=2, overlap=0.5,
                 mode="gaussian", bucket=32, compute_dtype=None):
        if mode not in ("gaussian", "constant"):
            raise ValueError(f"unknown blend mode {mode!r}")
        self.roi_size = tuple(roi_size)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.mode = mode
        self.bucket = bucket
        self.compute_dtype = compute_dtype

    def __call__(self, volume, predictor, tta_flips=None):
        return sliding_window_inference(
            volume, self.roi_size, predictor, overlap=self.overlap,
            sw_batch_size=self.sw_batch_size, bucket=self.bucket,
            mode=self.mode, compute_dtype=self.compute_dtype,
            tta_flips=tta_flips)
