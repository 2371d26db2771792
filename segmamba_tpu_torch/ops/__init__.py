"""Op layer of the port: plain-PyTorch scans and convs, and the wrappers of
the hand-written Hopper scan kernels (``csrc/gated_scan_fwd.cu``,
``csrc/gated_scan_bwd.cu``).

Counterpart of ``segmamba_tpu/ops``. Importing this package builds nothing;
the kernel library is compiled at its first launch (``_build.py``).
"""

from segmamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_directional,
)
from segmamba_tpu_torch.ops.mamba_inner import mamba_inner
from segmamba_tpu_torch.ops.scan_dir import (
    mamba_scan_fused_dir,
    mamba_scan_fused_dir_bwd_ref,
    mamba_scan_fused_dir_ref,
)
from segmamba_tpu_torch.ops.scan_fused import (
    mamba_scan_fused,
    mamba_scan_fused_bwd_ref,
    mamba_scan_fused_ref,
)
from segmamba_tpu_torch.ops.selective_scan import (
    selective_scan_chunked,
    selective_scan_ref,
)

__all__ = [
    "causal_conv1d",
    "causal_conv1d_directional",
    "mamba_inner",
    "mamba_scan_fused",
    "mamba_scan_fused_bwd_ref",
    "mamba_scan_fused_ref",
    "mamba_scan_fused_dir",
    "mamba_scan_fused_dir_bwd_ref",
    "mamba_scan_fused_dir_ref",
    "selective_scan_chunked",
    "selective_scan_ref",
]
