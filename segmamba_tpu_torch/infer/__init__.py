"""Inference layer of the port: sliding-window inference with gaussian
blending and window-level mirror TTA (counterpart of ``segmamba_tpu/infer``).
"""

from segmamba_tpu_torch.infer.sliding_window import (
    SlidingWindowInferer,
    sliding_window_inference,
)

__all__ = ["SlidingWindowInferer", "sliding_window_inference"]
