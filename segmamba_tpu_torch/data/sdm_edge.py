"""Signed-distance-map / edge auxiliary-target dataset (experimental).

A copy of ``segmamba_tpu/data/sdm_edge.py`` over the port's
``MedicalDataset`` (numpy and scipy only). It rebuilds the reference
SegMamba's ``light_training/dataloading/dataset_sdm_edge.py``, the
experimental variant whose segmentation target carries, per BraTS region
channel (TC/WT/ET), a normalized signed distance map plus the
boundary-edge mask:

- ``edge_map``: the mask minus its connectivity-1 binary erosion.
- ``compute_sdf``: inside/outside euclidean distances, min-max normalized
  to [-1, 1], zeroed on the inner boundary (skimage's
  ``find_boundaries(mode='inner')`` is ``mask & ~erosion(mask)``, i.e.
  ``edge_map``; scipy's EDT replaces skimage's).
- ``sdm_target``: ``1 - sdf + edge`` over the converted region labels, the
  recipe the reference's precomputed files follow.
- ``precompute_sdm``: the offline writer of ``<name>_seg_sdm.npy``.
- ``SdmEdgeDataset``: a ``MedicalDataset`` whose ``seg`` gains the sdm
  channels, with the sdm folder as a parameter.

Off the SegMamba main path; provided for the dataset family's
completeness.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage

from segmamba_tpu_torch.data.dataset import MedicalDataset


def convert_labels_regions(labels):
    """(Z, Y, X) BraTS labels -> (3, Z, Y, X) float TC/WT/ET masks
    (dataset_sdm_edge.py:87-92 without the torch wrapper)."""
    labels = np.asarray(labels)
    tc = (labels == 1) | (labels == 3)
    wt = tc | (labels == 2)
    et = labels == 3
    return np.stack([tc, wt, et]).astype(np.float32)


def edge_map(mask):
    """Binary boundary of ``mask``: voxels kept by the mask but not by its
    connectivity-1 erosion (dataset_sdm_edge.py:33-44). Leading axes are
    batch/channel; the trailing 3 (or 2) are spatial."""
    mask = np.asarray(mask)
    spatial = 3 if mask.ndim >= 3 else 2
    strt = ndimage.generate_binary_structure(spatial, 1)
    out = np.zeros(mask.shape, np.float32)
    flat = mask.reshape((-1,) + mask.shape[-spatial:])
    oflat = out.reshape(flat.shape)
    for i in range(flat.shape[0]):
        m = flat[i].astype(bool)
        ero = ndimage.binary_erosion(m, strt)
        oflat[i] = m.astype(np.uint8) - ero.astype(np.uint8)
    return out


def compute_sdf(img_gt, out_shape=None):
    """Normalized signed distance map per (batch, channel) volume
    (dataset_sdm_edge.py:56-85): -1 at the deepest inside point, +1 at the
    farthest outside point, 0 on the inner boundary; all-empty masks give 0.
    """
    img_gt = np.asarray(img_gt).astype(np.uint8)
    out_shape = tuple(out_shape) if out_shape is not None else img_gt.shape
    sdf_all = np.zeros(out_shape, np.float32)
    flat = img_gt.reshape((-1,) + img_gt.shape[-3:])
    oflat = sdf_all.reshape(flat.shape)
    for i in range(flat.shape[0]):
        posmask = flat[i].astype(bool)
        if not posmask.any():
            continue
        negmask = ~posmask
        posdis = ndimage.distance_transform_edt(posmask)
        negdis = ndimage.distance_transform_edt(negmask)
        boundary = posmask & ~ndimage.binary_erosion(
            posmask, ndimage.generate_binary_structure(3, 1))
        sdf = (negdis - negdis.min()) / max(negdis.max() - negdis.min(), 1e-8) \
            - (posdis - posdis.min()) / max(posdis.max() - posdis.min(), 1e-8)
        sdf[boundary] = 0.0
        oflat[i] = sdf
    return sdf_all


def sdm_target(seg):
    """(Z, Y, X) labels -> (3, Z, Y, X) training target ``1 - sdf + edge``
    over TC/WT/ET region masks — the recipe the reference's precomputed
    ``*_seg_sdm.npy`` files follow (dataset_sdm_edge.py:143-157)."""
    regions = convert_labels_regions(seg)[None]     # (1, 3, Z, Y, X)
    edge = edge_map(regions)
    sdm = 1.0 - compute_sdf(regions) + edge
    return sdm[0].astype(np.float32)


def precompute_sdm(datalist, out_dir):
    """Write ``<name>_seg_sdm.npy`` per case (the offline step the reference
    assumes has produced its ``train_sdm/`` folder)."""
    import pickle

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for p in datalist:
        seg = np.load(p.replace(".npz", "_seg.npy"), mmap_mode="r")
        try:  # the reference keys sdm files by the case's properties name
            with open(p[:-4] + ".pkl", "rb") as f:
                name = pickle.load(f)["name"]
        except Exception:
            name = os.path.basename(p)[:-4]
        out = os.path.join(out_dir, f"{name}_seg_sdm.npy")
        np.save(out, sdm_target(np.asarray(seg[0]))[None])
        paths.append(out)
    return paths


class SdmEdgeDataset(MedicalDataset):
    """MedicalDataset whose ``seg`` is concatenated with the precomputed sdm
    channels (dataset_sdm_edge.py:159-184; the hardcoded ``./data/fullres/
    train_sdm/`` path becomes the ``sdm_dir`` argument)."""

    def __init__(self, datalist, sdm_dir, test=False):
        super().__init__(datalist, test=test)
        self.sdm_dir = sdm_dir

    def __getitem__(self, i):
        item = super().__getitem__(i)
        if "seg" in item:
            name = item["properties"].get(
                "name", os.path.basename(self.datalist[i])[:-4])
            sdm = np.load(os.path.join(self.sdm_dir, f"{name}_seg_sdm.npy"),
                          mmap_mode="r")
            item["seg"] = np.concatenate([np.asarray(item["seg"]),
                                          np.asarray(sdm[0])], axis=0)
        return item
