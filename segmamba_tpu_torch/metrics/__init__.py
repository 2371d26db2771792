"""Segmentation metrics (pure numpy/scipy, medpy-free): a copy of
``segmamba_tpu/metrics``, with ``convert_labels_brats`` exported too."""

from segmamba_tpu_torch.metrics.metrics import (
    ALL_METRICS,
    dice,
    hausdorff_distance,
    hausdorff_distance_95,
    avg_surface_distance,
    avg_surface_distance_symmetric,
    convert_labels_brats,
)

__all__ = [
    "ALL_METRICS",
    "dice",
    "hausdorff_distance",
    "hausdorff_distance_95",
    "avg_surface_distance",
    "avg_surface_distance_symmetric",
    "convert_labels_brats",
]
