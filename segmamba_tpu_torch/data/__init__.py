"""Data layer of the port: NIfTI IO, offline preprocessing and planning,
datasets, patch sampling, augmentation and the host-side loader pipeline.

Copies of ``segmamba_tpu/data``'s ``nifti``, ``preprocessing``,
``planning``, ``dataset``, ``patch_sampler``, ``augment`` and ``loader``
modules (numpy and scipy only): the port imports
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
from segmamba_tpu_torch.data.nifti import read_nifti, write_nifti
from segmamba_tpu_torch.data.patch_sampler import PatchSampler
from segmamba_tpu_torch.data.preprocessing import (
    MultiModalityPreprocessor,
    compute_new_shape,
    crop_to_nonzero,
    resample_to_shape,
    run_case_npy,
)

__all__ = [
    "DataLoader",
    "MedicalDataset",
    "MultiModalityPreprocessor",
    "PatchSampler",
    "compute_new_shape",
    "crop_to_nonzero",
    "get_train_transforms",
    "get_train_val_test_loader_from_train",
    "get_validation_transforms",
    "read_nifti",
    "resample_to_shape",
    "run_case_npy",
    "unpack_dataset",
    "write_nifti",
]
