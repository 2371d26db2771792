"""Synthetic preprocessed cases, for tests and the chip smoke run.

Writes cases in the layout ``dataset.MedicalDataset`` reads (``<name>.npz``
with ``data`` (C, Z, Y, X) float32 and ``seg`` (1, Z, Y, X) int8, and
``<name>.pkl`` properties with ``class_locations``), made from a seed:
unit-normal images and one labelled box per foreground class, the image
brightened inside its box so that the labels are learnable.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


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
