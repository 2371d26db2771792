"""Synthetic cases, for tests and the chip smoke run.

``write_raw_phantom_case`` writes a raw case directory as a BraTS download
holds it after renaming (four modality NIfTI files and ``seg.nii.gz``): a
brain phantom, a seeded ellipsoid of nonzero int16 voxels in a zero frame,
with a nested tumour ellipsoid labelled 2 / 3 / 1 from the outside in.

``write_synthetic_cases`` writes preprocessed cases in the layout
``dataset.MedicalDataset`` reads (``<name>.npz`` with ``data`` (C, Z, Y, X)
float32 and ``seg`` (1, Z, Y, X) int8, and ``<name>.pkl`` properties with
``class_locations``), made from a seed: unit-normal images and one labelled
box per foreground class, the image brightened inside its box so that the
labels are learnable.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from segmamba_tpu_torch.data.nifti import write_nifti

MODALITIES = ("t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz", "t1c.nii.gz")
# the brain's radii as fractions of the frame: in the 155x240x240 BraTS
# frame its nonzero box rounds to 144x176x144
BRAIN_RADII = (0.44, 0.355, 0.28)


def phantom_case(shape, seed=0, channels=4):
    """(channels, *shape) int16 images and (*shape) uint8 labels of a brain
    phantom: zero outside an ellipsoid centred in the frame (jittered by
    the seed), a labelled tumour ellipsoid inside it, gaussian noise."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    grid = np.ogrid[tuple(slice(0, s) for s in shape)]
    centre = [s / 2 + rng.uniform(-2, 2) for s in shape]
    radii = [f * s for f, s in zip(BRAIN_RADII, shape)]
    dist = lambda c, r: sum(((g - ci) / ri) ** 2
                            for g, ci, ri in zip(grid, c, r))
    brain = dist(centre, radii) <= 1.0
    t_centre = [c + rng.uniform(-0.3, 0.3) * r for c, r in zip(centre, radii)]
    d = dist(t_centre, [0.35 * r for r in radii])
    labels = np.zeros(shape, np.uint8)
    labels[d <= 1.0] = 2
    labels[d <= 0.5] = 3
    labels[d <= 0.2] = 1
    labels[~brain] = 0
    images = np.zeros((channels, *shape), np.int16)
    for c in range(channels):
        level = 200 + 60 * c + 40 * labels.astype(np.float32) * (1 + c % 2)
        noise = rng.standard_normal(shape, dtype=np.float32) * 15
        images[c] = np.where(brain, np.rint(level + noise), 0)
    return images, labels


def write_raw_phantom_case(case_dir, shape, spacing=(1.0, 1.0, 1.0), seed=0,
                           data_filenames=MODALITIES,
                           seg_filename="seg.nii.gz"):
    """Write a phantom case (``phantom_case``) into ``case_dir``: one
    NIfTI file per modality and the labels; ``spacing`` is (x, y, z).
    Returns the images and the labels."""
    os.makedirs(case_dir, exist_ok=True)
    images, labels = phantom_case(shape, seed, len(data_filenames))
    for fname, img in zip(data_filenames, images):
        write_nifti(os.path.join(case_dir, fname), img, spacing=spacing)
    if seg_filename:
        write_nifti(os.path.join(case_dir, seg_filename), labels,
                    spacing=spacing)
    return images, labels


def write_synthetic_cases(folder, n_cases, shape, channels=4, labels=(1, 2),
                          seed=0, max_locations=10000):
    """Write ``n_cases`` cases of ``shape`` voxels into ``folder``; returns
    their ``.npz`` paths."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_cases):
        data = rng.standard_normal((channels, *shape), dtype=np.float32)
        seg = np.zeros((1, *shape), np.int8)
        for lab in labels:
            size = [max(2, s // 4) for s in shape]
            lo = [int(rng.integers(0, s - e + 1)) for s, e in zip(shape, size)]
            box = tuple(slice(a, a + e) for a, e in zip(lo, size))
            seg[(0, *box)] = lab
            data[(slice(None), *box)] += float(lab)
        locations = {}
        for lab in labels:
            loc = np.argwhere(seg == lab)
            if len(loc) > max_locations:
                loc = loc[rng.choice(len(loc), max_locations, replace=False)]
            locations[lab] = loc
        stem = os.path.join(folder, f"case_{i:04d}")
        np.savez(stem + ".npz", data=data, seg=seg)
        with open(stem + ".pkl", "wb") as f:
            pickle.dump({"class_locations": locations,
                         "shape_after_resample": list(shape)}, f)
        paths.append(stem + ".npz")
    return paths
