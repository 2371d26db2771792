"""LiTS / Liver-2017 CT recipe (liver=1, tumor=2).

Twin of the JAX package's ``examples/liver2017_ct.py`` (the reference's
``light_training/examples/liver2017/2_preprocessing_liver2017.py`` with
its ``default_preprocessor_liver_2017.py``): single CT modality, two
labels, an anisotropic target spacing, and CT normalization whose window
comes from the dataset plan's foreground percentile statistics (the
reference reads ``data_analysis_result.txt`` into its CTNormalization;
here the plan JSON that ``plan`` writes plays that role through
``ct_norm_params_from_plan``).

    python -m segmamba_tpu_torch.examples.liver2017_ct plan|preprocess|train

``train`` runs on the card.
"""

import argparse
import functools
import os

from segmamba_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from segmamba_tpu_torch.data.planning import (
    ct_norm_params_from_plan,
    load_plan,
    save_plan,
)
from segmamba_tpu_torch.data.preprocessing import (
    MultiModalityPreprocessor,
    ct_normalize_with_seg,
    ct_znorm_from_stats,
)
from segmamba_tpu_torch.examples import train


def get_config():
    return Config(
        model=ModelConfig(in_chans=1, out_chans=3),
        data=DataConfig(
            base_dir="./data/raw_data/Liver_2017/",
            image_dir="images",
            data_filenames=("image.nii.gz",),
            seg_filename="label.nii.gz",
            all_labels=(1, 2),
            # the reference's liver recipe resamples to an anisotropic
            # target (1.0 x 0.7676 x 0.7676 mm)
            target_spacing=(1.0, 0.76757812, 0.76757812),
            normalization="ct",
        ),
        train=TrainConfig(logdir="./logs/segmamba_liver2017",
                          loss="dice_ce"),
    )


def _make_preprocessor(cfg: Config, plan=None):
    if plan is not None:
        # nnU-Net CTNormalization: plan percentile window + dataset z-score
        norm = functools.partial(ct_znorm_from_stats,
                                 **ct_norm_params_from_plan(plan))
    else:  # fallback: generic abdominal soft-tissue window
        norm = functools.partial(ct_normalize_with_seg, a_min=-17.0,
                                 a_max=201.0)
    return MultiModalityPreprocessor(
        base_dir=cfg.data.base_dir, image_dir=cfg.data.image_dir,
        data_filenames=list(cfg.data.data_filenames),
        seg_filename=cfg.data.seg_filename, normalize_fn=norm)


def plan(cfg: Config):
    pp = _make_preprocessor(cfg)
    result = pp.run_plan()
    path = os.path.join(cfg.data.base_dir, "plan.json")
    save_plan(result, path)
    print(f"plan written to {path}: fullres spacing "
          f"{result['fullres_spacing']}, patch {result.get('patch_size')}")


def preprocess(cfg: Config, num_processes=8):
    plan_path = os.path.join(cfg.data.base_dir, "plan.json")
    p = load_plan(plan_path) if os.path.exists(plan_path) else None
    pp = _make_preprocessor(cfg, plan=p)
    pp.run(output_spacing=list(cfg.data.target_spacing),
           output_dir=cfg.data.preprocessed_dir,
           all_labels=list(cfg.data.all_labels),
           num_processes=num_processes)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["plan", "preprocess", "train"])
    args = ap.parse_args()
    cfg = get_config()
    {"plan": plan, "preprocess": preprocess, "train": train}[args.stage](cfg)
