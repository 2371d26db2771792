"""Op layer of the port: plain-PyTorch scans, convs, decode steps and
norms, and the wrappers of the hand-written Hopper kernels
(``csrc/gated_scan_fwd.cu``, ``csrc/gated_scan_bwd.cu``: K1-K5 through
``scan_dir`` / ``scan_fused``, K6 through ``scan_core``;
``csrc/proj_scan_*.cu``: K8 through ``scan_proj``; ``csrc/mxu_scan_*.cu``:
the ratio-form scan K7 through ``scan_mxu``; ``csrc/conv3d_k3s1_fwd.cu``
and ``csrc/conv3d_k3s1_dw.cu``: the channels-last 3x3x3 conv K9 and its
weight gradient through ``conv3d``); the sequence-parallel scan and inner
op on K6 (``scan_sharded``).

Counterpart of ``segmamba_tpu/ops``. Importing this package builds nothing;
the kernel library is compiled at its first launch (``_build.py``).
"""

from segmamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_directional,
    causal_conv1d_update,
)
from segmamba_tpu_torch.ops.conv3d import (
    conv3d_k3s1,
    conv3d_k3s1_dw_ref,
    conv3d_k3s1_ref,
    conv3d_k3s1_supported,
    conv3d_k3s1_v2,
)
from segmamba_tpu_torch.ops.fused_norm import layer_norm_fn, rms_norm_fn
from segmamba_tpu_torch.ops.mamba_inner import mamba_inner
from segmamba_tpu_torch.ops.scan_core import (
    selective_scan_core_bwd_ref,
    selective_scan_core_ref,
    selective_scan_kernel,
)
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
from segmamba_tpu_torch.ops.scan_mxu import (
    selective_scan_mxu,
    selective_scan_mxu_core_bwd_ref,
    selective_scan_mxu_core_ref,
)
from segmamba_tpu_torch.ops.scan_sharded import (
    mamba_inner_sharded,
    selective_scan_sharded,
)
# the dispatcher ``selective_scan`` stays under its module's path:
# ``segmamba_tpu_torch.ops.selective_scan`` names the module
from segmamba_tpu_torch.ops.selective_scan import (
    selective_scan_chunked,
    selective_scan_ref,
)
from segmamba_tpu_torch.ops.selective_state_update import (
    selective_state_update,
)

__all__ = [
    "causal_conv1d",
    "causal_conv1d_directional",
    "causal_conv1d_update",
    "conv3d_k3s1",
    "conv3d_k3s1_dw_ref",
    "conv3d_k3s1_ref",
    "conv3d_k3s1_supported",
    "conv3d_k3s1_v2",
    "layer_norm_fn",
    "mamba_inner",
    "mamba_inner_sharded",
    "mamba_scan_fused",
    "mamba_scan_fused_bwd_ref",
    "mamba_scan_fused_ref",
    "mamba_scan_fused_dir",
    "mamba_scan_fused_dir_bwd_ref",
    "mamba_scan_fused_dir_ref",
    "rms_norm_fn",
    "selective_scan_chunked",
    "selective_scan_core_bwd_ref",
    "selective_scan_core_ref",
    "selective_scan_kernel",
    "selective_scan_mxu",
    "selective_scan_mxu_core_bwd_ref",
    "selective_scan_mxu_core_ref",
    "selective_scan_ref",
    "selective_scan_sharded",
    "selective_state_update",
]
