"""Normalize BraTS2023 download filenames: strip the case-name prefix so each
case directory holds {t1c,t1n,t2f,t2w,seg}.nii.gz.

Port of ``1_rename_mri_data.py`` (``CASE-mod.nii.gz`` -> ``mod.nii.gz``).

    python -m segmamba_tpu_torch.rename [DATA_DIR] [--dry-run]
"""

from __future__ import annotations

import argparse
import os


def rename_cases(data_dir, dry_run=False):
    """Rename every ``<case>/<prefix>-<mod>`` file to ``<case>/<mod>``;
    returns the number of files renamed (or that would be)."""
    renamed = 0
    for case_name in sorted(os.listdir(data_dir)):
        case_dir = os.path.join(data_dir, case_name)
        if not os.path.isdir(case_dir):
            continue
        for data_name in sorted(os.listdir(case_dir)):
            if "-" not in data_name:
                continue
            new_name = data_name.split("-")[-1]
            old_path = os.path.join(case_dir, data_name)
            new_path = os.path.join(case_dir, new_name)
            if dry_run:
                print(f"{old_path} -> {new_path}")
            else:
                os.rename(old_path, new_path)
            renamed += 1
    print(f"renamed {renamed} files in {data_dir}")
    return renamed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", nargs="?",
                    default="./data/raw_data/BraTS2023/ASNR-MICCAI-"
                            "BraTS2023-GLI-Challenge-TrainingData/")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    return rename_cases(args.data_dir, args.dry_run)


if __name__ == "__main__":
    main()
