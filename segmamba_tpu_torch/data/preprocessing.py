"""Offline preprocessing: crop -> normalize -> resample -> properties.

A copy of ``segmamba_tpu/data/preprocessing.py`` (the port imports nothing
of the JAX package); its planning and NIfTI helpers come from the port's own
``data/planning.py`` and ``data/nifti.py``.

Rebuilds the reference preprocessors
(the reference SegMamba's light_training/preprocessing/preprocessors/
default_preprocessor.py:154-292, preprocessor_mri.py:30-134) and their
helpers (cropping/cropping.py:24-49, normalization/
default_normalization_schemes.py:28-130, resampling/default_resampling.py)
with numpy + scipy only. Array convention: ``data (C, Z, Y, X)`` float32,
``seg (1, Z, Y, X)``. The ``.npz {data, seg}`` + ``.pkl`` properties format
and every property key match the reference so inference can invert the chain
(prediction.py:40,75,80).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
from typing import Sequence

import numpy as np
from scipy import ndimage

ANISO_THRESHOLD = 3.0  # nnU-Net separate-z anisotropy ratio


# ---------------------------------------------------------------------------
# cropping
# ---------------------------------------------------------------------------


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """True where any channel is nonzero, holes filled (cropping.py:8-21)."""
    mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        mask |= data[c] != 0
    return ndimage.binary_fill_holes(mask)


def bbox_from_mask(mask: np.ndarray):
    """[[zmin, zmax), [ymin, ymax), [xmin, xmax)] of the True region."""
    bbox = []
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        line = mask.any(axis=other)
        nz = np.nonzero(line)[0]
        if len(nz) == 0:
            bbox.append([0, mask.shape[ax]])
        else:
            bbox.append([int(nz[0]), int(nz[-1]) + 1])
    return bbox


def crop_to_nonzero(data, seg=None, nonzero_label=-1):
    """Crop to the nonzero bounding box; mark outside-region voxels in seg
    with ``nonzero_label`` (cropping.py:24-49)."""
    mask = create_nonzero_mask(data)
    bbox = bbox_from_mask(mask)
    slicer = tuple(slice(b[0], b[1]) for b in bbox)
    data = data[(slice(None),) + slicer]
    mask = mask[slicer][None]
    if seg is not None:
        seg = seg[(slice(None),) + slicer]
        seg[(seg == 0) & (~mask)] = nonzero_label
    else:
        seg = np.where(mask, 0, nonzero_label).astype(np.int8)
    return data, seg, bbox


# ---------------------------------------------------------------------------
# normalization schemes (default_normalization_schemes.py)
# ---------------------------------------------------------------------------


def zscore_normalize(image, seg=None, use_mask: bool = False):
    """Per-volume z-score; optionally restricted to the seg>=0 region
    (ZScoreNormalization, default_normalization_schemes.py:28-50)."""
    image = image.astype(np.float32)
    if use_mask and seg is not None:
        m = seg >= 0
        mean, std = image[m].mean(), image[m].std()
        image[m] = (image[m] - mean) / max(std, 1e-8)
    else:
        mean, std = image.mean(), image.std()
        image = (image - mean) / max(std, 1e-8)
    return image


def ct_normalize(image, a_min, a_max, b_min=0.0, b_max=1.0, clip=True):
    """CT windowing + rescale (CTNormStandard, :83-103)."""
    image = image.astype(np.float32)
    image = (image - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        image = np.clip(image, b_min, b_max)
    return image


def ct_znorm_from_stats(image, seg=None, *, a_min, a_max, mean, std):
    """nnU-Net ``CTNormalization``: clip to the dataset-plan percentile
    window [p0.5, p99.5] then z-score with the DATASET foreground mean/std
    (not per-volume stats; default_normalization_schemes.py:82-94). The four
    parameters come from the plan's ``intensity_statistics_per_channel``
    (``planning.ct_norm_params_from_plan``)."""
    del seg
    image = image.astype(np.float32)
    image = np.clip(image, a_min, a_max)
    return (image - mean) / max(std, 1e-8)


def rescale_01(image):
    """Min-max rescale (Rescale01, :105-117)."""
    image = image.astype(np.float32)
    lo, hi = image.min(), image.max()
    return (image - lo) / max(hi - lo, 1e-8)


def ct_normalize_with_seg(image, seg=None, *, a_min, a_max, b_min=0.0,
                          b_max=1.0, clip=True):
    """(image, seg)-signature adapter for ``ct_normalize`` so a
    functools.partial of it can serve as a picklable ``normalize_fn``."""
    del seg
    return ct_normalize(image, a_min, a_max, b_min, b_max, clip)


# ---------------------------------------------------------------------------
# resampling (default_resampling.py semantics, scipy backend)
# ---------------------------------------------------------------------------


def compute_new_shape(old_shape, old_spacing, new_spacing):
    """round(shape * old/new) per axis (default_resampling.py:23-30)."""
    return np.array([int(round(sp / nsp * sh)) for sh, sp, nsp in
                     zip(old_shape, old_spacing, new_spacing)])


def _get_do_separate_z(spacing, threshold=ANISO_THRESHOLD):
    return (np.max(spacing) / np.min(spacing)) > threshold


def _resample_channel(chan, new_shape, order):
    if tuple(chan.shape) == tuple(new_shape):
        return chan.astype(np.float32)
    zoom = [n / o for n, o in zip(new_shape, chan.shape)]
    return ndimage.zoom(chan.astype(np.float32), zoom, order=order,
                        mode="nearest", grid_mode=True).astype(np.float32)


def _resample_seg_channel(chan, new_shape, order):
    """Per-label one-hot resampling to avoid label interpolation artifacts
    (nnU-Net's is_seg path in resample_data_or_seg)."""
    if tuple(chan.shape) == tuple(new_shape):
        return chan.copy()
    labels = np.unique(chan)
    out = np.zeros(new_shape, dtype=chan.dtype)
    maxprob = np.zeros(new_shape, dtype=np.float32)
    for lab in labels:
        prob = _resample_channel((chan == lab).astype(np.float32), new_shape,
                                 order)
        sel = prob > maxprob
        out[sel] = lab
        maxprob = np.maximum(maxprob, prob)
    return out


def resample_to_shape(data, new_shape, current_spacing=None, is_seg=False,
                      order=3, order_z=0, force_separate_z=None):
    """Resample (C, Z, Y, X) to (C, *new_shape).

    Mirrors ``resample_data_or_seg_to_shape`` (default_resampling.py:78-217):
    anisotropic volumes (ratio > 3) are resampled in-plane with ``order`` and
    along the low-res axis with ``order_z`` (separate-z).
    """
    new_shape = tuple(int(s) for s in new_shape)
    do_sep = force_separate_z
    axis = None
    if do_sep is None and current_spacing is not None:
        do_sep = _get_do_separate_z(current_spacing)
        if do_sep:
            axis = int(np.argmax(current_spacing))
    elif do_sep and current_spacing is not None:
        axis = int(np.argmax(current_spacing))
    resample_one = _resample_seg_channel if is_seg else _resample_channel

    out = np.zeros((data.shape[0],) + new_shape,
                   dtype=data.dtype if is_seg else np.float32)
    for c in range(data.shape[0]):
        chan = data[c]
        if do_sep and axis is not None:
            # in-plane first at `order`, then along the low-res axis at order_z
            moved = np.moveaxis(chan, axis, 0)
            plane_shape = tuple(np.delete(new_shape, axis))
            planes = np.stack([
                resample_one(sl, plane_shape, order)
                for sl in moved], axis=0)
            planes = np.moveaxis(planes, 0, axis)
            out[c] = resample_one(planes, new_shape, order_z)
        else:
            out[c] = resample_one(chan, new_shape, order)
    return out


# ---------------------------------------------------------------------------
# foreground sampling
# ---------------------------------------------------------------------------


def sample_foreground_locations(seg, classes: Sequence, seed: int = 1234,
                                num_samples: int = 10000,
                                min_percent_coverage: float = 0.01):
    """Up to 10k voxel coordinates per class, >=1% coverage
    (default_preprocessor.py:453-482)."""
    rndst = np.random.RandomState(seed)
    class_locs = {}
    for c in classes:
        key = tuple(c) if isinstance(c, (tuple, list)) else c
        if isinstance(c, (tuple, list)):
            mask = np.isin(seg, np.asarray(c))
        else:
            mask = seg == c
        locs = np.argwhere(mask)
        if len(locs) == 0:
            class_locs[key] = []
            continue
        target = min(num_samples, len(locs))
        target = max(target, int(np.ceil(len(locs) * min_percent_coverage)))
        class_locs[key] = locs[rndst.choice(len(locs), target, replace=False)]
    return class_locs


# ---------------------------------------------------------------------------
# preprocessors
# ---------------------------------------------------------------------------


def run_case_npy(data, seg, properties, out_spacing,
                 normalize_fn=zscore_normalize, all_labels=(1, 2, 3),
                 sample_fg: bool = True, do_crop: bool = True,
                 do_resample: bool = True):
    """The core chain: crop -> normalize -> resample, recording the inverse
    metadata (default_preprocessor.py:154-227). Property keys are identical
    to the reference's.

    ``do_crop=False`` / ``do_resample=False`` reproduce the reference's
    noresample_nocrop preprocessor variant
    (preprocessor_multiinput_mrinorm_noresample_nocrop.py) — the inverse
    metadata then records identity transforms so prediction's un-resample /
    un-crop steps remain valid. ``all_labels`` entries may be label TUPLES
    for region-based oversampling (preprocessor_multiinput_and_region.py
    semantics — class_locations keyed by region).
    """
    data = np.copy(np.asarray(data, np.float32))
    original_spacing = list(properties["spacing"])          # (x, y, z)
    original_spacing_trans = original_spacing[::-1]         # (z, y, x)
    properties["original_spacing_trans"] = original_spacing_trans
    properties["target_spacing_trans"] = list(out_spacing)

    properties["shape_before_cropping"] = data.shape[1:]
    if do_crop:
        data, seg, bbox = crop_to_nonzero(data, seg)
    else:
        bbox = [[0, s] for s in data.shape[1:]]
    properties["bbox_used_for_cropping"] = bbox
    properties["shape_after_cropping_before_resample"] = data.shape[1:]

    new_shape = (compute_new_shape(data.shape[1:], original_spacing_trans,
                                   out_spacing)
                 if do_resample else list(data.shape[1:]))
    seg_for_norm = seg if seg is not None else np.zeros_like(data)
    for c in range(data.shape[0]):
        data[c] = normalize_fn(data[c], seg_for_norm[0])

    if do_resample:
        data = resample_to_shape(data, new_shape, original_spacing_trans,
                                 order=3, order_z=0)
    properties["shape_after_resample"] = new_shape

    if seg is not None:
        if do_resample:
            seg = resample_to_shape(seg, new_shape, original_spacing_trans,
                                    is_seg=True, order=1, order_z=0)
        if sample_fg:
            properties["class_locations"] = sample_foreground_locations(
                seg, list(all_labels))
        seg = seg.astype(np.int16 if np.max(seg) > 127 else np.int8)
    return data, seg


def _save_case(output_dir, name, data, seg, properties):
    os.makedirs(output_dir, exist_ok=True)
    np.savez_compressed(os.path.join(output_dir, name + ".npz"),
                        data=data, seg=seg)
    with open(os.path.join(output_dir, name + ".pkl"), "wb") as f:
        pickle.dump(properties, f)


class MultiModalityPreprocessor:
    """MRI multi-modality preprocessor (preprocessor_mri.py:32-134):
    per-case directory with N modality files + optional seg file, per-channel
    z-score, parallel over cases."""

    def __init__(self, base_dir, image_dir, data_filenames, seg_filename="",
                 reader=None, normalize_fn=None, do_crop=True,
                 do_resample=True):
        self.base_dir = base_dir
        self.image_dir = image_dir
        self.data_filenames = list(data_filenames)
        self.seg_filename = seg_filename
        # must be module-level/partial callables: workers pickle this (spawn)
        self.reader = reader or _read_with_spacing
        self.normalize_fn = normalize_fn or zscore_normalize
        # variant switches covering the reference's CT / region /
        # noresample_nocrop preprocessor files (see run_case_npy docstring)
        self.do_crop = do_crop
        self.do_resample = do_resample

    def get_iterable_list(self):
        return sorted(os.listdir(os.path.join(self.base_dir, self.image_dir)))

    def read_data(self, case_name):
        case_dir = os.path.join(self.base_dir, self.image_dir, case_name)
        vols, spacing = [], (1.0, 1.0, 1.0)
        for fname in self.data_filenames:
            arr, spacing = self.reader(os.path.join(case_dir, fname))
            vols.append(arr.astype(np.float32)[None])
        data = np.concatenate(vols, axis=0)
        seg = None
        if self.seg_filename:
            seg_arr, _ = self.reader(os.path.join(case_dir, self.seg_filename))
            seg = seg_arr.astype(np.float32)[None]
        properties = {
            "spacing": spacing,
            "raw_size": data.shape[1:],
            "name": case_name.split(".")[0],
        }
        return data, seg, properties

    def run_case(self, case_name):
        data, seg, properties = self.read_data(case_name)
        data, seg = run_case_npy(data, seg, properties, self.out_spacing,
                                 normalize_fn=self.normalize_fn,
                                 all_labels=self.all_labels,
                                 do_crop=self.do_crop,
                                 do_resample=self.do_resample)
        return data, seg, properties

    def run_case_save(self, case_name):
        data, seg, properties = self.run_case(case_name)
        _save_case(self.output_dir, case_name.split(".")[0], data, seg,
                   properties)
        return case_name

    def run(self, output_spacing, output_dir, all_labels, num_processes=8):
        """Parallel preprocessing over cases; raises if a worker dies
        (default_preprocessor.py:505-523's watchdog semantics)."""
        self.out_spacing = list(output_spacing)
        self.all_labels = list(all_labels)
        self.output_dir = output_dir
        cases = self.get_iterable_list()
        os.makedirs(output_dir, exist_ok=True)
        if num_processes <= 1 or len(cases) <= 1:
            for c in cases:
                self.run_case_save(c)
            return
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(num_processes) as pool:
            for _ in pool.imap_unordered(self.run_case_save, cases):
                pass

    # -- dataset fingerprint ("plan", default_preprocessor.py:347-410) ----

    def run_plan(self, sample_cases: int | None = 20):
        """Dataset fingerprint + nnU-Net experiment plan: per-case spacing /
        post-crop shape / seeded foreground-intensity samples, then the full
        heuristic chain (target spacing, patch size, pool/conv kernels,
        percentile intensity statistics) via ``data.planning.build_plan``
        (default_preprocessor.py:347-410)."""
        from segmamba_tpu_torch.data.planning import (build_plan,
                                                collect_foreground_intensities)

        cases = self.get_iterable_list()
        if sample_cases:
            cases = cases[:sample_cases]
        spacings, shapes, fg_per_case, means, stds = [], [], [], [], []
        for case in cases:
            data, seg, props = self.read_data(case)
            # the reference fingerprints the cropped shape (experiment_plan
            # crops before measuring); keep that so patch-size heuristics
            # see the trainable extent
            if self.do_crop:
                data, seg, _ = crop_to_nonzero(data, seg)
            spacings.append(list(props["spacing"])[::-1])
            shapes.append(data.shape[1:])
            if seg is not None:
                fg_per_case.append(
                    collect_foreground_intensities(seg, data))
                fg = data[:, seg[0] > 0]
                if fg.size:
                    means.append(float(fg.mean()))
                    stds.append(float(fg.std()))
        if not fg_per_case:  # unlabeled data: plan from whole volumes
            fg_per_case = [
                [c.reshape(-1)[:: max(1, c.size // 10000)] for c in d]
                for d in [self.read_data(c)[0] for c in cases[:2]]]
        plan = build_plan(spacings, shapes, fg_per_case)
        # legacy keys kept for round-1/2 consumers
        plan["median_spacing"] = plan["fullres_spacing"]
        plan["foreground_mean"] = float(np.mean(means)) if means else None
        plan["foreground_std"] = float(np.mean(stds)) if stds else None
        plan["n_cases"] = len(cases)
        return plan


def _read_with_spacing(path):
    from segmamba_tpu_torch.data.nifti import read_nifti
    img = read_nifti(path, with_meta=True)
    return img.array, img.spacing
