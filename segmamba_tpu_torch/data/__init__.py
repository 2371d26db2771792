"""Data layer of the port: NIfTI IO, offline preprocessing and planning,
datasets, patch sampling, augmentation and the host-side loader pipeline.

Copies of ``segmamba_tpu/data``'s ``nifti``, ``preprocessing``,
``planning``, ``dataset``, ``patch_sampler``, ``augment``, ``loader``
and ``sdm_edge`` modules (numpy and scipy; the resampler and the crop in
``segmamba_tpu_torch.native``): the port imports nothing of the JAX
package. Batches come out NCDHW for the port's model.
``augment_device`` is the port of the on-device augmentation chain
(torch, on the batch's device).
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
from segmamba_tpu_torch.data.sdm_edge import SdmEdgeDataset, precompute_sdm

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
    "SdmEdgeDataset",
    "precompute_sdm",
    "unpack_dataset",
    "write_nifti",
]
