"""Data layer of the port: datasets, patch sampling, augmentation and the
host-side loader pipeline.

Copies of ``segmamba_tpu/data``'s ``dataset``, ``patch_sampler``,
``augment`` and ``loader`` modules (numpy and scipy only): the port imports
nothing of the JAX package. Batches come out NCDHW for the port's model.
On-device augmentation (``segmamba_tpu/data/augment_device.py``) is not
ported yet.
"""

from segmamba_tpu_torch.data.augment import (
    get_train_transforms,
    get_validation_transforms,
)
from segmamba_tpu_torch.data.dataset import (
    MedicalDataset,
    get_train_val_test_loader_from_train,
    unpack_dataset,
)
from segmamba_tpu_torch.data.loader import DataLoader
from segmamba_tpu_torch.data.patch_sampler import PatchSampler

__all__ = [
    "DataLoader",
    "MedicalDataset",
    "PatchSampler",
    "get_train_transforms",
    "get_train_val_test_loader_from_train",
    "get_validation_transforms",
    "unpack_dataset",
]
