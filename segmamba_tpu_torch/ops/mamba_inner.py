"""Mamba inner op: causal conv1d + projections + fused gated scan.

Port of ``segmamba_tpu/ops/mamba_inner.py`` ``mamba_inner`` on its fused
path (:52-59): the scan, softplus, D-skip and ``silu(z)`` gate run in
``scan_fused.mamba_scan_fused`` (the Hopper kernel for CUDA tensors, the
plain version for CPU tensors). Weights are in the JAX package's
``(in, out)`` matmul layout; a torch ``Linear.weight`` is the transpose.
"""

from __future__ import annotations

from segmamba_tpu_torch.ops import scan_fused
from segmamba_tpu_torch.ops.causal_conv1d import causal_conv1d


def mamba_inner(xz, conv_weight, conv_bias, x_proj, dt_proj, dt_bias, A,
                D_skip, *, d_state):
    """One Mamba direction on a pre-projected sequence.

    xz: (batch, L, 2*d_inner) — in_proj output, [x | z] halves;
    conv_weight: (width, d_inner); conv_bias: (d_inner,) or None;
    x_proj: (d_inner, dt_rank + 2*d_state); dt_proj: (dt_rank, d_inner);
    dt_bias: (d_inner,) float32; A: (d_inner, d_state); D_skip: (d_inner,).
    Returns (batch, L, d_inner) in xz.dtype, gated, before out_proj.
    """
    d_inner = xz.shape[-1] // 2
    x, z = xz[..., :d_inner], xz[..., d_inner:]
    dt_rank = x_proj.shape[1] - 2 * d_state
    x = causal_conv1d(x, conv_weight, conv_bias, activation="silu")
    x_dbl = x @ x_proj.to(x.dtype)
    dt = x_dbl[..., :dt_rank] @ dt_proj.to(x.dtype)
    B = x_dbl[..., dt_rank:dt_rank + d_state]
    C = x_dbl[..., dt_rank + d_state:]
    return scan_fused.mamba_scan_fused(x, dt, z, A, B, C, D_skip, dt_bias)
