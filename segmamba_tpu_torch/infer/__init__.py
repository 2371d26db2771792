"""Inference layer of the port: sliding-window inference with gaussian
blending and window-level mirror TTA, whole-volume single-shot inference and
its TTA, and the Predictor's inverse preprocessing and NIfTI export
(counterpart of ``segmamba_tpu/infer``).
"""

from segmamba_tpu_torch.infer.predictor import Predictor
from segmamba_tpu_torch.infer.sliding_window import (
    SlidingWindowInferer,
    sliding_window_inference,
)
from segmamba_tpu_torch.infer.whole_volume import (
    WholeVolumePredictor,
    nonzero_bbox,
    num_slices_for_shape,
    pad_to_multiple,
    whole_volume_inference,
    whole_volume_tta,
)

__all__ = [
    "Predictor",
    "SlidingWindowInferer",
    "WholeVolumePredictor",
    "nonzero_bbox",
    "num_slices_for_shape",
    "pad_to_multiple",
    "sliding_window_inference",
    "whole_volume_inference",
    "whole_volume_tta",
]
