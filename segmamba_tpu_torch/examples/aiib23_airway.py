"""AIIB23 airway-tree CT recipe.

Twin of the JAX package's ``examples/aiib23_airway.py`` (the reference's
``examples/2_preprocessing_AIIB23.py`` and its train / predict variants):
single CT modality, binary airway labels, CT windowing normalization
instead of per-volume z-score.

    python -m segmamba_tpu_torch.examples.aiib23_airway preprocess|train
"""

import argparse
import functools

from segmamba_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from segmamba_tpu_torch.data.preprocessing import (
    MultiModalityPreprocessor,
    ct_normalize_with_seg,
)
from segmamba_tpu_torch.examples import train


def get_config():
    return Config(
        model=ModelConfig(in_chans=1, out_chans=2),
        data=DataConfig(
            base_dir="./data/raw_data/AIIB23/",
            image_dir="images",
            data_filenames=("image.nii.gz",),
            seg_filename="label.nii.gz",
            all_labels=(1,),
            normalization="ct",
        ),
        train=TrainConfig(logdir="./logs/segmamba_aiib23", loss="dice_ce"),
    )


def preprocess(cfg: Config, num_processes=8):
    # lung CT window (a_min/a_max follow the airway task's intensity range)
    pp = MultiModalityPreprocessor(
        base_dir=cfg.data.base_dir, image_dir=cfg.data.image_dir,
        data_filenames=list(cfg.data.data_filenames),
        seg_filename=cfg.data.seg_filename,
        normalize_fn=functools.partial(ct_normalize_with_seg,
                                       a_min=-1000.0, a_max=600.0))
    pp.run(output_spacing=list(cfg.data.target_spacing),
           output_dir=cfg.data.preprocessed_dir,
           all_labels=list(cfg.data.all_labels),
           num_processes=num_processes)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["preprocess", "train"])
    args = ap.parse_args()
    cfg = get_config()
    if args.stage == "preprocess":
        preprocess(cfg)
    else:
        train(cfg)
