"""AbdomenAtlas multi-organ CT recipe.

Twin of the JAX package's ``examples/abdomen_atlas.py`` (the reference's
AbdomenAtlas scripts): single CT modality, 9 organ classes, dice+CE with
foreground oversampling. ``python -m
segmamba_tpu_torch.examples.abdomen_atlas`` prints the config as JSON.
"""

from segmamba_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)


def get_config():
    return Config(
        model=ModelConfig(in_chans=1, out_chans=10),
        data=DataConfig(
            base_dir="./data/raw_data/AbdomenAtlas/",
            image_dir="images",
            data_filenames=("ct.nii.gz",),
            seg_filename="combined_labels.nii.gz",
            all_labels=tuple(range(1, 10)),
            normalization="ct",
        ),
        train=TrainConfig(logdir="./logs/segmamba_abdomen", loss="dice_ce",
                          patch_size=(128, 128, 128)),
    )


if __name__ == "__main__":
    print(get_config().to_json())
