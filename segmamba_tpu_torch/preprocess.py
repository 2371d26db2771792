"""Offline preprocessing: BraTS2023 NIfTI -> ``.npz`` / ``.pkl`` cases.

Port of ``2_preprocessing_mri.py``: plan the dataset (written to
``<output-dir>/data_analysis_result.json``), then crop, z-score and
resample every case of ``<base-dir>/<image-dir>`` to ``--spacing`` with
four modalities and labels {1, 2, 3}, over ``--num-processes`` spawned
workers. numpy and scipy only; it runs on the host.

    python -m segmamba_tpu_torch.preprocess \\
        --base-dir ./data/raw_data/BraTS2023/ \\
        --output-dir ./data/fullres/train/ [--plan-only]
"""

from __future__ import annotations

import argparse
import json
import os

from segmamba_tpu_torch.data.preprocessing import MultiModalityPreprocessor

DATA_FILENAMES = ["t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz", "t1c.nii.gz"]
SEG_FILENAME = "seg.nii.gz"


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-dir", default="./data/raw_data/BraTS2023/")
    ap.add_argument("--image-dir",
                    default="ASNR-MICCAI-BraTS2023-GLI-Challenge-TrainingData")
    ap.add_argument("--output-dir", default="./data/fullres/train/")
    ap.add_argument("--spacing", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    ap.add_argument("--labels", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--num-processes", type=int, default=8)
    ap.add_argument("--no-seg", action="store_true",
                    help="test data without segmentations")
    ap.add_argument("--data-filenames", nargs="+", default=DATA_FILENAMES,
                    help="per-case modality filenames (default: BraTS 4)")
    ap.add_argument("--plan-only", action="store_true")
    ap.add_argument("--no-crop", action="store_true",
                    help="skip crop-to-nonzero (noresample_nocrop variant)")
    ap.add_argument("--no-resample", action="store_true",
                    help="keep native spacing (noresample_nocrop variant)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    pp = MultiModalityPreprocessor(
        base_dir=args.base_dir, image_dir=args.image_dir,
        data_filenames=list(args.data_filenames),
        seg_filename="" if args.no_seg else SEG_FILENAME,
        do_crop=not args.no_crop, do_resample=not args.no_resample)

    plan = pp.run_plan()
    print(json.dumps(plan, indent=2))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "data_analysis_result.json"),
              "w") as f:
        json.dump(plan, f, indent=2)
    if not args.plan_only:
        pp.run(output_spacing=list(args.spacing), output_dir=args.output_dir,
               all_labels=list(args.labels), num_processes=args.num_processes)
    return plan


if __name__ == "__main__":
    main()
