"""Preprocessed-case dataset + the train/val/test split.

A copy of ``segmamba_tpu/data/dataset.py`` (``unpack_dataset``,
``MedicalDataset``, ``get_train_val_test_loader_from_train``), kept in the
port because the port imports nothing of the JAX package. One addition: a
``MedicalDataset`` pickles as its case list only (see ``__getstate__``). Cases are
``.npz {data, seg}`` + ``.pkl`` properties, unpacked once to ``.npy`` /
``_seg.npy`` for zero-copy memory-mapped reads in the sampler workers.
numpy only.
"""

from __future__ import annotations

import glob
import os
import pickle
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def unpack_dataset(folder, unpack_segmentation=True, overwrite_existing=False,
                   num_processes=8):
    """.npz -> .npy (+ _seg.npy) for memmap access (dataloading/utils.py:15)."""
    npzs = sorted(glob.glob(os.path.join(folder, "*.npz")))

    def _unpack(path):
        stem = path[:-4]
        if overwrite_existing or not os.path.isfile(stem + ".npy"):
            with np.load(path) as z:
                np.save(stem + ".npy", z["data"])
                if unpack_segmentation and "seg" in z and z["seg"].ndim > 0:
                    np.save(stem + "_seg.npy", z["seg"])

    with ThreadPoolExecutor(max_workers=num_processes) as ex:
        list(ex.map(_unpack, npzs))


class MedicalDataset:
    """Case list with cached properties and memory-mapped volumes
    (dataset.py:27-98)."""

    def __init__(self, datalist, test=False):
        self.datalist = list(datalist)
        self.test = test
        self._load_properties()
        folders = sorted({os.path.dirname(p) for p in self.datalist})
        for f in folders:
            unpack_dataset(f, unpack_segmentation=True,
                           overwrite_existing=False)

    def _load_properties(self):
        self.properties = []
        for p in self.datalist:
            with open(p[:-4] + ".pkl", "rb") as f:
                self.properties.append(pickle.load(f))

    # A loader process receives the dataset pickled through a pipe that the
    # parent fills before the child has imported anything; with the
    # properties (class_locations: megabytes) inside, every process start
    # waited for the previous child's imports. The case list is enough: the
    # child re-reads the properties.
    def __getstate__(self):
        return {"datalist": self.datalist, "test": self.test}

    def __setstate__(self, state):
        self.datalist, self.test = state["datalist"], state["test"]
        self._load_properties()

    def __len__(self):
        return len(self.datalist)

    def __getitem__(self, i):
        path = self.datalist[i]
        image = np.load(path.replace(".npz", ".npy"), mmap_mode="r")
        item = {"data": image, "properties": self.properties[i]}
        if not self.test:
            item["seg"] = np.load(path.replace(".npz", "_seg.npy"),
                                  mmap_mode="r")
        return item


def get_train_val_test_loader_from_train(data_dir, train_rate=0.7,
                                         val_rate=0.1, test_rate=0.2,
                                         seed=42):
    """70/10/20 shuffled split, seed 42 (dataset.py:244-271).

    Membership note: the reference seed-42-shuffles the *raw glob order*
    (filesystem/readdir-dependent, dataset.py:247-255); this version sorts
    before the same shuffle, so splits are reproducible across machines but
    case-level membership can differ from a particular reference run.
    """
    all_paths = sorted(glob.glob(f"{data_dir}/*.npz"))
    train_n = int(len(all_paths) * train_rate)
    val_n = int(len(all_paths) * val_rate)
    test_n = int(len(all_paths) * test_rate)
    random.seed(seed)
    random.shuffle(all_paths)
    train, val = all_paths[:train_n], all_paths[train_n:train_n + val_n]
    test = all_paths[-test_n:] if test_n else []
    return (MedicalDataset(train), MedicalDataset(val), MedicalDataset(test))
