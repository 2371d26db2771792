"""Prediction on the test split: sliding window + mirror TTA (or one
whole-volume forward per flip) -> inverse resample and crop -> NIfTI, with
a quick TC/WT/ET dice per case.

Port of ``4_predict.py`` with its flags. Cases run one after another on one
card. ``--checkpoint`` is a checkpoint file (the port trainer's, or a
reference ``state_dict`` ``.pt``) or a directory searched for
``best_model_*.pt``.

    python -m segmamba_tpu_torch.predict --data-dir ./data/fullres/train \\
        --checkpoint ./logs/segmamba/model [--whole-volume] [--device cuda]

``--device`` defaults to ``cuda`` and raises when there is no card;
``--device cpu`` (or ``--cpu``) runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from scipy import ndimage

from segmamba_tpu_torch.data import get_train_val_test_loader_from_train
from segmamba_tpu_torch.infer import (
    Predictor,
    SlidingWindowInferer,
    WholeVolumePredictor,
)
from segmamba_tpu_torch.metrics import convert_labels_brats, dice
from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.train.checkpoint import (
    find_checkpoint,
    load_model_weights,
)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default="./data/fullres/train")
    ap.add_argument("--checkpoint", default="./logs/segmamba/model",
                    help="checkpoint file, or a directory holding "
                         "best_model_*.pt")
    ap.add_argument("--save-dir", default="./prediction_results/segmamba")
    ap.add_argument("--roi", type=int, nargs=3, default=[128, 128, 128])
    ap.add_argument("--sw-batch-size", type=int, default=2)
    ap.add_argument("--overlap", type=float, default=0.5)
    ap.add_argument("--mirror", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--whole-volume", action="store_true",
                    help="one whole-volume forward per flip instead of "
                         "sliding windows (infer/whole_volume.py)")
    ap.add_argument("--feats", type=int, nargs=4, default=[48, 96, 192, 384])
    ap.add_argument("--depths", type=int, nargs=4, default=[2, 2, 2, 2])
    ap.add_argument("--hidden-size", type=int, default=768)
    ap.add_argument("--num-slices", type=int, nargs=4,
                    default=[64, 32, 16, 8])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    ap.add_argument("--split", type=float, nargs=3, default=[0.7, 0.1, 0.2],
                    help="train/val/test fractions (must match the train "
                         "run's)")
    return ap


def resolve_checkpoint(path):
    """A file as given; a directory's ``best_model_*.pt`` (else any
    checkpoint there)."""
    if os.path.isdir(path):
        found = find_checkpoint(path, "best_model")
        if found is None:
            raise SystemExit(f"no checkpoint found under {path}")
        return found
    if not os.path.isfile(path):
        raise SystemExit(f"no checkpoint at {path}")
    return path


def case_dice(seg, gt):
    """TC/WT/ET dice of the prediction ``seg`` at model resolution against
    the preprocessed ``gt``, resampled (nearest) to ``seg``'s shape."""
    zoom = [t / s for t, s in zip(seg.shape, gt.shape)]
    gt_c = convert_labels_brats(ndimage.zoom(gt, zoom, order=0))
    pred_c = convert_labels_brats(seg)
    return [dice(pred_c[k], gt_c[k]) for k in range(3)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = SegMamba(in_chans=4, out_chans=4, depths=tuple(args.depths),
                     feat_size=tuple(args.feats),
                     hidden_size=args.hidden_size,
                     num_slices_list=tuple(args.num_slices), dtype=dtype,
                     device=device).eval()
    path = resolve_checkpoint(args.checkpoint)
    print(f"loading checkpoint: {path}")
    load_model_weights(model, path)

    if args.whole_volume:
        predictor = WholeVolumePredictor(model, mirror_axes=tuple(args.mirror))
    else:
        inferer = SlidingWindowInferer(tuple(args.roi),
                                       sw_batch_size=args.sw_batch_size,
                                       overlap=args.overlap, mode="gaussian")
        predictor = Predictor(inferer, mirror_axes=tuple(args.mirror))

    _, _, test_ds = get_train_val_test_loader_from_train(
        args.data_dir, train_rate=args.split[0], val_rate=args.split[1],
        test_rate=args.split[2])
    print(f"test cases: {len(test_ds)}")

    all_dices = []
    for i in range(len(test_ds)):
        item = test_ds[i]
        props = item["properties"]
        x = torch.from_numpy(np.array(item["data"], np.float32))[None]
        logits = predictor.maybe_mirror_and_predict(x.to(device), model,
                                                    num_classes=4)
        raw = predictor.predict_raw_probability(logits, props)
        seg = np.argmax(raw, axis=0)
        if "seg" in item:
            ds = case_dice(seg, np.asarray(item["seg"][0]))
            all_dices.append(ds)
            print(f"{props['name']}: tc={ds[0]:.4f} wt={ds[1]:.4f} "
                  f"et={ds[2]:.4f}")
        full = predictor.predict_noncrop_probability(seg[None], props)
        predictor.save_to_nii(full, props, args.save_dir)

    if all_dices:
        mean = np.nanmean(np.asarray(all_dices, np.float64), axis=0)
        print(f"mean dice: tc={mean[0]:.4f} wt={mean[1]:.4f} "
              f"et={mean[2]:.4f} overall={np.nanmean(mean):.4f}")
    return all_dices


if __name__ == "__main__":
    main()
