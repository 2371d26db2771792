"""Typed configuration for the whole pipeline, PyTorch.

Copy of ``segmamba_tpu/config.py`` (``ModelConfig``, ``DataConfig``,
``TrainConfig``, ``InferConfig``, ``Config`` with ``to_json`` /
``from_json``): one dataclass tree that serializes to and from JSON, with
the same fields and defaults, so a file written by the JAX package's
``Config.to_json`` loads here unchanged (unknown keys are dropped, as
there). ``Config.build_model`` returns the port's ``SegMamba``, on the card
unless the caller asks for the CPU; ``Config.build_mesh`` the data mesh of
``train.data_parallel`` over the launched ranks.

``ModelConfig.scan_impl`` takes the JAX package's names (see
``models/mamba.py``): "auto" and "pallas" are the chained "dir2"
composition on the card, "dir", "proj" and "fused" the other kernel
compositions, "chunked" and "ref" the plain cores.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Sequence

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class ModelConfig:
    in_chans: int = 4
    out_chans: int = 4
    depths: Sequence[int] = (2, 2, 2, 2)
    feat_size: Sequence[int] = (48, 96, 192, 384)
    hidden_size: int = 768
    num_slices_list: Sequence[int] = (64, 32, 16, 8)
    dtype: str = "bfloat16"          # compute dtype; params stay f32
    scan_impl: str = "auto"
    remat: bool | str = False        # False | "convs" | True


@dataclass
class DataConfig:
    base_dir: str = "./data/raw_data/BraTS2023/"
    image_dir: str = "ASNR-MICCAI-BraTS2023-GLI-Challenge-TrainingData"
    preprocessed_dir: str = "./data/fullres/train"
    data_filenames: Sequence[str] = ("t2w.nii.gz", "t2f.nii.gz",
                                     "t1n.nii.gz", "t1c.nii.gz")
    seg_filename: str = "seg.nii.gz"
    target_spacing: Sequence[float] = (1.0, 1.0, 1.0)
    all_labels: Sequence[int] = (1, 2, 3)
    normalization: str = "zscore"     # zscore | ct | rescale01
    num_processes: int = 8


@dataclass
class TrainConfig:
    logdir: str = "./logs/segmamba"
    max_epochs: int = 1000
    batch_size: int = 2
    val_every: int = 2
    num_step_per_epoch: int = 250
    val_number: int = 100
    patch_size: Sequence[int] = (128, 128, 128)
    augmentation: str = "default"    # default|nomirror|onlymirror|onlyspatial|noaug
    learning_rate: float = 1e-2
    weight_decay: float = 3e-5
    momentum: float = 0.99
    grad_clip: float = 12.0
    scheduler: str = "poly"
    loss: str = "ce"                 # ce | dice_ce
    num_workers: int = 8
    seed: int = 42
    data_parallel: bool = False
    resume: bool = False


@dataclass
class InferConfig:
    roi_size: Sequence[int] = (128, 128, 128)
    sw_batch_size: int = 2
    overlap: float = 0.5
    blend_mode: str = "gaussian"
    mirror_axes: Sequence[int] = (0, 1, 2)
    shape_bucket: int = 32
    save_dir: str = "./prediction_results/segmamba"
    postprocess_largest_cc: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)

    def to_json(self, path=None):
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str):
        s = path_or_str
        if not path_or_str.lstrip().startswith("{"):
            with open(path_or_str) as f:
                s = f.read()
        raw = json.loads(s)

        def build(dc, d):
            known = {f.name for f in dataclasses.fields(dc)}
            return dc(**{k: v for k, v in d.items() if k in known})

        return cls(model=build(ModelConfig, raw.get("model", {})),
                   data=build(DataConfig, raw.get("data", {})),
                   train=build(TrainConfig, raw.get("train", {})),
                   infer=build(InferConfig, raw.get("infer", {})))

    def build_mesh(self, device=None):
        """``train.data_parallel``'s mesh: ("data",) over every launched
        rank (the default process group must exist, as under ``torchrun``
        after ``parallel.multihost.initialize_multihost``), or None."""
        if not self.train.data_parallel:
            return None
        from segmamba_tpu_torch.parallel.mesh import make_mesh
        return make_mesh(device=device)

    def build_model(self, device="cuda", generator=None, mesh=None):
        """The port's ``SegMamba`` for this model config, with random
        weights from ``generator`` (seed 0 by default), on ``device``;
        ``mesh`` (``build_mesh``'s) goes to its Mamba layers."""
        from segmamba_tpu_torch.models import SegMamba

        m = self.model
        if m.dtype not in DTYPES:
            raise ValueError(f"dtype={m.dtype!r}; one of {tuple(DTYPES)}")
        return SegMamba(
            in_chans=m.in_chans, out_chans=m.out_chans,
            depths=tuple(m.depths), feat_size=tuple(m.feat_size),
            hidden_size=m.hidden_size,
            num_slices_list=tuple(m.num_slices_list),
            scan_impl=m.scan_impl, remat=m.remat, dtype=DTYPES[m.dtype],
            generator=generator, device=device, mesh=mesh)
