"""Offline metrics: Dice + HD95 per TC/WT/ET over saved predictions.

Port of ``5_compute_metrics.py``: the same per-case table (dice 1 / HD95 0
when both masks of a region are empty, dice 0 / HD95 373.13 when one is),
the ``<out>/<pred_name>.npy`` dump of shape (cases, 3, 2) and the summary
lines. numpy and scipy only; it runs on the host.

    python -m segmamba_tpu_torch.compute_metrics --pred_name segmamba \\
        --pred-dir ./prediction_results --gt-dir ./data/fullres/train
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
from scipy import ndimage

from segmamba_tpu_torch.data.nifti import read_nifti
from segmamba_tpu_torch.infer.predictor import Predictor
from segmamba_tpu_torch.metrics import (
    convert_labels_brats,
    dice,
    hausdorff_distance_95,
)


def each_case_metric(gt, pred, voxel_spacing=None):
    """(3, 2): dice and HD95 of TC, WT, ET."""
    gt_c = convert_labels_brats(gt)
    pr_c = convert_labels_brats(pred)
    out = np.zeros((3, 2))
    for i in range(3):
        g, p = gt_c[i], pr_c[i]
        if g.sum() == 0 and p.sum() == 0:
            out[i] = [1.0, 0.0]
        elif g.sum() == 0 or p.sum() == 0:
            out[i] = [0.0, 373.13]
        else:
            out[i, 0] = dice(p, g)
            out[i, 1] = hausdorff_distance_95(p, g,
                                              voxel_spacing=voxel_spacing)
    return out


def preprocessed_gt(gt_dir, name):
    """The preprocessed case's seg mapped back to the raw frame (nearest
    resample + uncrop), or None when the case has no ``.npz``."""
    npz = os.path.join(gt_dir, f"{name}.npz")
    if not os.path.isfile(npz):
        return None
    with np.load(npz) as z:
        seg = z["seg"][0]
    with open(os.path.join(gt_dir, f"{name}.pkl"), "rb") as f:
        props = pickle.load(f)
    tgt = props["shape_after_cropping_before_resample"]
    zoom = [t / s for t, s in zip(tgt, seg.shape)]
    seg_rs = ndimage.zoom(seg, zoom, order=0)
    return Predictor.predict_noncrop_probability(seg_rs[None], props)[0]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pred_name", default="segmamba")
    ap.add_argument("--pred-dir", default="./prediction_results")
    ap.add_argument("--gt-dir", default="./data/fullres/train",
                    help="dir of preprocessed cases (.npz with seg) or raw "
                         "NIfTI ground truths")
    ap.add_argument("--raw-gt", action="store_true",
                    help="gt-dir holds <case>/seg.nii.gz raw files")
    ap.add_argument("--out", default="./metrics")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    pred_dir = os.path.join(args.pred_dir, args.pred_name)
    preds = sorted(f for f in os.listdir(pred_dir) if f.endswith(".nii.gz"))
    print(f"{len(preds)} predictions in {pred_dir}")

    results = []
    for fname in preds:
        name = fname.replace(".nii.gz", "")
        pred = read_nifti(os.path.join(pred_dir, fname))
        if args.raw_gt:
            gt = read_nifti(os.path.join(args.gt_dir, name, "seg.nii.gz"))
        else:
            gt = preprocessed_gt(args.gt_dir, name)
            if gt is None:
                print(f"skip {name}: no ground truth")
                continue
        m = each_case_metric(gt, pred)
        results.append(m)
        print(f"{name}: dice={m[:, 0].round(4)} hd95={m[:, 1].round(2)}")

    if not results:
        return None
    arr = np.stack(results)  # (n, 3, 2)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, f"{args.pred_name}.npy"), arr)
    print("mean dice (tc, wt, et):", np.nanmean(arr[:, :, 0], 0).round(4))
    print("std  dice:", np.nanstd(arr[:, :, 0], 0).round(4))
    print("mean hd95:", np.nanmean(arr[:, :, 1], 0).round(2))
    print("overall mean dice:", float(np.nanmean(arr[:, :, 0])))
    return arr


if __name__ == "__main__":
    main()
