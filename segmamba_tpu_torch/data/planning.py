"""Dataset fingerprint / experiment planning (nnU-Net heuristics).

A copy of ``segmamba_tpu/data/planning.py`` (the port imports nothing of the
JAX package).

Rebuilds the planning half of the reference preprocessor
(the reference SegMamba's light_training/preprocessing/preprocessors/
default_preprocessor.py):

- ``get_pool_and_conv_props`` (:59-134) — derive per-axis pooling counts,
  pool/conv kernel sizes, and the padded patch size from a spacing +
  initial patch size, stopping at ``min_feature_map_size``.
- ``determine_fullres_target_spacing`` (:304-333) — median spacing with the
  anisotropic-dataset correction (10th-percentile spacing for a low-res axis
  that is >3x coarser AND >3x smaller than the others).
- ``collect_foreground_intensities`` (:413-451) — 10k seeded foreground
  samples per channel for the dataset-level percentile statistics.
- ``build_plan`` (:347-410 ``run_plan``) — assembles the full plan dict
  (intensity stats incl. percentile_00_5/99_5, fullres spacing, median shape,
  initial + padded patch size, pool/conv kernels).

Unlike the reference — whose ``data_analysis_result.txt`` is never read back
(SURVEY.md §5 config) — the plan produced here is consumed by ``python -m
segmamba_tpu_torch.train --plan plan.json`` (patch size) and by CT
normalization (percentile window), closing the plan -> train loop.
"""

from __future__ import annotations

import json
import math

import numpy as np


def get_shape_must_be_divisible_by(num_pool_per_axis):
    """2**pools per axis (default_preprocessor.py:36-37)."""
    return [2 ** int(p) for p in num_pool_per_axis]


def pad_shape(shape, must_be_divisible_by):
    """Round ``shape`` up to the next multiple per axis (no-op when already
    divisible — default_preprocessor.py:39-57)."""
    return [int(s) if s % m == 0 else int(s + m - s % m)
            for s, m in zip(shape, must_be_divisible_by)]


def get_pool_and_conv_props(spacing, patch_size, min_feature_map_size,
                            max_numpool):
    """Per-axis pooling plan (default_preprocessor.py:59-134).

    Repeatedly halve every axis whose current feature-map size allows it
    (>= 2*min_feature_map_size) and whose current spacing is within a factor
    of 2 of the finest poolable axis; conv kernels start at 1 per axis and
    become (and stay) 3 once the axis's spacing is within 2x of the finest.
    Returns (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
    padded_patch_size, shape_must_be_divisible_by).

    Note: the reference indexes ``spacings_of_axes[d]`` with a full-range
    axis index (:108-114), which only stays in bounds because kernels reach
    3 before axes drop out; this implementation uses the intended
    ``current_spacing[d]`` comparison directly.
    """
    dim = len(spacing)
    current_spacing = [float(s) for s in spacing]
    current_size = [float(p) for p in patch_size]

    pool_op_kernel_sizes = [[1] * dim]
    conv_kernel_sizes = []
    num_pool_per_axis = [0] * dim
    kernel_size = [1] * dim

    while True:
        valid = [i for i in range(dim)
                 if current_size[i] >= 2 * min_feature_map_size]
        if not valid:
            break
        min_spacing = min(current_spacing[i] for i in valid)
        valid = [i for i in valid
                 if current_spacing[i] / min_spacing < 2
                 and num_pool_per_axis[i] < max_numpool]
        if len(valid) == 1 and \
                current_size[valid[0]] < 3 * min_feature_map_size:
            break
        if not valid:
            break

        for d in range(dim):
            if kernel_size[d] != 3 and \
                    current_spacing[d] / min(current_spacing) < 2:
                kernel_size[d] = 3

        pool = [1] * dim
        for v in valid:
            pool[v] = 2
            num_pool_per_axis[v] += 1
            current_spacing[v] *= 2
            current_size[v] = math.ceil(current_size[v] / 2)
        pool_op_kernel_sizes.append(pool)
        conv_kernel_sizes.append(list(kernel_size))

    must_divide = get_shape_must_be_divisible_by(num_pool_per_axis)
    padded = pad_shape([int(p) for p in patch_size], must_divide)
    conv_kernel_sizes.append([3] * dim)  # bottleneck conv
    return (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
            padded, must_divide)


def determine_fullres_target_spacing(spacings, sizes):
    """Median spacing, corrected for strongly anisotropic datasets
    (default_preprocessor.py:304-333)."""
    spacings = np.vstack(spacings).astype(np.float64)
    sizes = np.vstack(sizes).astype(np.float64)
    target = np.percentile(spacings, 50, axis=0)
    target_size = np.percentile(sizes, 50, axis=0)
    worst = int(np.argmax(target))
    others = [i for i in range(len(target)) if i != worst]
    other_spacings = [target[i] for i in others]
    other_sizes = [target_size[i] for i in others]
    if (target[worst] > 3 * max(other_spacings)
            and target_size[worst] * 3 < min(other_sizes)):
        t = np.percentile(spacings[:, worst], 10)
        if t < max(other_spacings):
            t = max(max(other_spacings), t) + 1e-5
        target[worst] = t
    return target


def collect_foreground_intensities(seg, images, seed=1234, num_samples=10000):
    """10k seeded samples (with replacement) of each channel's seg>0 voxels
    (default_preprocessor.py:413-451). images (C, *spatial), seg (1, *spatial)
    or (*spatial). Returns a list of per-channel sample arrays."""
    seg = np.asarray(seg)
    fg_mask = (seg[0] if seg.ndim == images.ndim else seg) > 0
    rs = np.random.RandomState(seed)
    out = []
    for c in range(images.shape[0]):
        fg = images[c][fg_mask]
        out.append(rs.choice(fg, num_samples, replace=True) if len(fg)
                   else np.asarray([], np.float32))
    return out


def initial_patch_size(target_spacing):
    """Isotropic-voxel-budget seed patch: 256^3 voxels distributed
    inversely to spacing (default_preprocessor.py:389-390)."""
    tmp = 1.0 / np.asarray(target_spacing, np.float64)
    return [int(round(i)) for i in tmp * (256 ** 3 / np.prod(tmp)) ** (1 / 3)]


def build_plan(spacings, shapes, fg_intensities_per_channel,
               min_feature_map_size=4, max_numpool=999999):
    """Assemble the dataset plan (run_plan semantics,
    default_preprocessor.py:347-410). ``fg_intensities_per_channel``:
    list over cases of lists over channels of sample arrays."""
    n_channels = len(fg_intensities_per_channel[0])
    per_channel = [
        np.concatenate([np.asarray(case[c], np.float64)
                        for case in fg_intensities_per_channel
                        if len(case[c])])
        if any(len(case[c]) for case in fg_intensities_per_channel)
        else np.asarray([0.0])
        for c in range(n_channels)
    ]
    intensity_stats = {
        str(c): {
            "mean": float(np.mean(v)),
            "median": float(np.median(v)),
            "std": float(np.std(v)),
            "min": float(np.min(v)),
            "max": float(np.max(v)),
            "percentile_99_5": float(np.percentile(v, 99.5)),
            "percentile_00_5": float(np.percentile(v, 0.5)),
        }
        for c, v in enumerate(per_channel)
    }

    fullres = determine_fullres_target_spacing(spacings, shapes)
    new_shapes = [
        [int(round(sp / nsp * sh)) for sh, sp, nsp in zip(shape, spc, fullres)]
        for spc, shape in zip(spacings, shapes)]
    median_shape = np.median(np.asarray(new_shapes, np.float64), axis=0)

    init_patch = initial_patch_size(fullres)
    (num_pool, pool_kernels, conv_kernels, patch,
     must_divide) = get_pool_and_conv_props(
        fullres, init_patch, min_feature_map_size, max_numpool)

    return {
        "intensity_statistics_per_channel": intensity_stats,
        "fullres_spacing": [float(s) for s in fullres],
        "median_shape": [float(s) for s in median_shape],
        "initial_patch_size": init_patch,
        "patch_size": [int(p) for p in patch],
        "num_pool_per_axis": num_pool,
        "pool_op_kernel_sizes": pool_kernels,
        "conv_kernel_sizes": conv_kernels,
        "shape_must_be_divisible_by": must_divide,
    }


def save_plan(plan, path):
    with open(path, "w") as f:
        json.dump(plan, f, indent=2)


def load_plan(path):
    with open(path) as f:
        return json.load(f)


def ct_norm_params_from_plan(plan, channel=0):
    """CT windowing parameters from the plan's percentile stats — the
    nnU-Net CTNormalization recipe (clip to [p0.5, p99.5], z-score with the
    dataset fg mean/std; default_normalization_schemes.py:83-103)."""
    s = plan["intensity_statistics_per_channel"][str(channel)]
    return {
        "a_min": s["percentile_00_5"],
        "a_max": s["percentile_99_5"],
        "mean": s["mean"],
        "std": s["std"],
    }
