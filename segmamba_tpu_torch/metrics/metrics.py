"""Confusion-matrix and surface-distance metrics.

A copy of ``segmamba_tpu/metrics/metrics.py`` (the port imports nothing of
the JAX package).

Rebuilds the metric inventory of
the reference SegMamba's light_training/evaluation/metric.py (ConfusionMatrix :25,
dice/jaccard/precision/recall/... :105-330, HD/HD95/ASD/ASSD via medpy
:332-385, ALL_METRICS registry :386-405) with numpy + scipy distance
transforms instead of medpy. Inputs are binary masks (any shape);
``voxelspacing`` is per-axis physical spacing.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


class ConfusionMatrix:
    def __init__(self, test=None, reference=None):
        self.test = None
        self.reference = None
        self.tp = self.fp = self.tn = self.fn = None
        if test is not None:
            self.set_test(test)
        if reference is not None:
            self.set_reference(reference)

    def set_test(self, test):
        self.test = np.asarray(test).astype(bool)
        self._reset()

    def set_reference(self, reference):
        self.reference = np.asarray(reference).astype(bool)
        self._reset()

    def _reset(self):
        self.tp = self.fp = self.tn = self.fn = None

    def compute(self):
        t, r = self.test, self.reference
        if t is None or r is None:
            raise ValueError("test and reference must be set")
        self.tp = int(np.count_nonzero(t & r))
        self.fp = int(np.count_nonzero(t & ~r))
        self.tn = int(np.count_nonzero(~t & ~r))
        self.fn = int(np.count_nonzero(~t & r))

    def get_matrix(self):
        if self.tp is None:
            self.compute()
        return self.tp, self.fp, self.tn, self.fn

    def get_existence(self):
        tp, fp, tn, fn = self.get_matrix()
        return tp + fn > 0, tp + fp > 0  # (reference_nonempty, test_nonempty)


def _cm(test, reference, confusion_matrix=None):
    if confusion_matrix is None:
        confusion_matrix = ConfusionMatrix(test, reference)
    return confusion_matrix


def _surface_defined(cm):
    """Surface metrics are defined only when both masks are non-empty AND
    non-full — the reference wrapper NaNs on any of the four degeneracies
    (evaluation/metric.py:312-345: test_empty/test_full/reference_empty/
    reference_full)."""
    tp, fp, tn, fn = cm.get_matrix()
    ref_nonempty, test_nonempty = tp + fn > 0, tp + fp > 0
    ref_full, test_full = fp + tn == 0, fn + tn == 0
    return ref_nonempty and test_nonempty and not ref_full and not test_full


def dice(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True):
    """2TP / (2TP + FP + FN)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    if tp + fp + fn == 0:
        return float("nan") if nan_for_nonexisting else 0.0
    return 2.0 * tp / (2 * tp + fp + fn)


def jaccard(test=None, reference=None, confusion_matrix=None,
            nan_for_nonexisting=True):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    if tp + fp + fn == 0:
        return float("nan") if nan_for_nonexisting else 0.0
    return tp / (tp + fp + fn)


def precision(test=None, reference=None, confusion_matrix=None,
              nan_for_nonexisting=True):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, _, _ = cm.get_matrix()
    if tp + fp == 0:
        return float("nan") if nan_for_nonexisting else 0.0
    return tp / (tp + fp)


def recall(test=None, reference=None, confusion_matrix=None,
           nan_for_nonexisting=True):
    cm = _cm(test, reference, confusion_matrix)
    tp, _, _, fn = cm.get_matrix()
    if tp + fn == 0:
        return float("nan") if nan_for_nonexisting else 0.0
    return tp / (tp + fn)


sensitivity = recall


def specificity(test=None, reference=None, confusion_matrix=None,
                nan_for_nonexisting=True):
    cm = _cm(test, reference, confusion_matrix)
    _, fp, tn, _ = cm.get_matrix()
    if tn + fp == 0:
        return float("nan") if nan_for_nonexisting else 0.0
    return tn / (tn + fp)


def accuracy(test=None, reference=None, confusion_matrix=None, **kw):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return (tp + tn) / max(tp + fp + tn + fn, 1)


def fscore(test=None, reference=None, confusion_matrix=None, beta=1.0,
           nan_for_nonexisting=True):
    p = precision(test, reference, confusion_matrix, nan_for_nonexisting)
    r = recall(test, reference, confusion_matrix, nan_for_nonexisting)
    if np.isnan(p) or np.isnan(r) or (p + r) == 0:
        return float("nan") if nan_for_nonexisting else 0.0
    return (1 + beta ** 2) * p * r / (beta ** 2 * p + r)


def false_positive_rate(test=None, reference=None, confusion_matrix=None, **kw):
    return 1.0 - specificity(test, reference, confusion_matrix)


def false_negative_rate(test=None, reference=None, confusion_matrix=None, **kw):
    return 1.0 - recall(test, reference, confusion_matrix)


# ---------------------------------------------------------------------------
# surface distances (medpy __surface_distances equivalent)
# ---------------------------------------------------------------------------


def _surface_distances(result, reference, voxelspacing=None):
    """Distances from result's surface voxels to reference's surface."""
    result = np.atleast_1d(np.asarray(result, bool))
    reference = np.atleast_1d(np.asarray(reference, bool))
    if voxelspacing is not None:
        voxelspacing = np.atleast_1d(
            np.asarray(voxelspacing, np.float64)).tolist()
    footprint = ndimage.generate_binary_structure(result.ndim, 1)
    if not result.any() or not reference.any():
        raise RuntimeError("surface distance undefined for empty masks")
    res_border = result ^ ndimage.binary_erosion(result, footprint, 1)
    ref_border = reference ^ ndimage.binary_erosion(reference, footprint, 1)
    dt = ndimage.distance_transform_edt(~ref_border, sampling=voxelspacing)
    return dt[res_border]


def hausdorff_distance(test=None, reference=None, confusion_matrix=None,
                       nan_for_nonexisting=True, voxel_spacing=None, **kw):
    cm = _cm(test, reference, confusion_matrix)
    if not _surface_defined(cm):
        return float("nan") if nan_for_nonexisting else 0.0
    d1 = _surface_distances(cm.test, cm.reference, voxel_spacing)
    d2 = _surface_distances(cm.reference, cm.test, voxel_spacing)
    return float(max(d1.max(), d2.max()))


def hausdorff_distance_95(test=None, reference=None, confusion_matrix=None,
                          nan_for_nonexisting=True, voxel_spacing=None, **kw):
    cm = _cm(test, reference, confusion_matrix)
    if not _surface_defined(cm):
        return float("nan") if nan_for_nonexisting else 0.0
    d1 = _surface_distances(cm.test, cm.reference, voxel_spacing)
    d2 = _surface_distances(cm.reference, cm.test, voxel_spacing)
    # medpy hd95: the 95th percentile of the POOLED distances (not the max
    # of per-direction percentiles) — the oracle the reference calls
    # (evaluation/metric.py:346, medpy.metric.binary.hd95)
    return float(np.percentile(np.hstack([d1, d2]), 95))


def avg_surface_distance(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, voxel_spacing=None, **kw):
    cm = _cm(test, reference, confusion_matrix)
    if not _surface_defined(cm):
        return float("nan") if nan_for_nonexisting else 0.0
    return float(_surface_distances(cm.test, cm.reference,
                                    voxel_spacing).mean())


def avg_surface_distance_symmetric(test=None, reference=None,
                                   confusion_matrix=None,
                                   nan_for_nonexisting=True,
                                   voxel_spacing=None, **kw):
    cm = _cm(test, reference, confusion_matrix)
    if not _surface_defined(cm):
        return float("nan") if nan_for_nonexisting else 0.0
    # medpy assd: unweighted mean of the two directional means (NOT the mean
    # of the pooled distances — they differ when the surfaces have different
    # voxel counts; evaluation/metric.py:383, medpy.metric.binary.assd)
    d1 = _surface_distances(cm.test, cm.reference, voxel_spacing)
    d2 = _surface_distances(cm.reference, cm.test, voxel_spacing)
    return float((d1.mean() + d2.mean()) / 2.0)


ALL_METRICS = {
    "False Positive Rate": false_positive_rate,
    "Dice": dice,
    "Jaccard": jaccard,
    "Hausdorff Distance": hausdorff_distance,
    "Hausdorff Distance 95": hausdorff_distance_95,
    "Precision": precision,
    "Recall": recall,
    "Avg. Symmetric Surface Distance": avg_surface_distance_symmetric,
    "Avg. Surface Distance": avg_surface_distance,
    "Accuracy": accuracy,
    "False Negative Rate": false_negative_rate,
    "Sensitivity": sensitivity,
    "Specificity": specificity,
    "F1": fscore,
}


def convert_labels_brats(labels):
    """BraTS label -> (TC, WT, ET) binary channels
    (4_predict.py:30-34: TC = 1|3, WT = 1|2|3, ET = 3)."""
    labels = np.asarray(labels)
    tc = (labels == 1) | (labels == 3)
    wt = tc | (labels == 2)
    et = labels == 3
    return np.stack([tc, wt, et], axis=0)
