"""Mamba inner op: causal conv1d + projections + selective scan + gate.

Port of ``segmamba_tpu/ops/mamba_inner.py`` ``mamba_inner`` (:24-64). For
CUDA tensors ``impl`` "auto", "pallas" and "fused" take the fused path
(:52-59): the scan, softplus, D-skip and ``silu(z)`` gate run in
``scan_fused.mamba_scan_fused`` (the K2 kernel). "fused" takes it on the
CPU too (its plain version). Otherwise the scan is
``selective_scan(impl=...)``: on the CPU "auto" is its chunked plain core;
"mxu" is the ratio-form scan K7 (``scan_mxu``) on either device.
Weights are in the JAX package's ``(in, out)`` matmul layout; a torch
``Linear.weight`` is the transpose.
"""

from __future__ import annotations

from segmamba_tpu_torch.ops import scan_fused
from segmamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from segmamba_tpu_torch.ops.selective_scan import selective_scan


def projections(x, x_proj, dt_proj, d_state, reduce=None):
    """dt, B and C of the conv output ``x`` (..., L, d_inner): x_proj
    (d_inner, dt_rank + 2 d_state), dt_proj (dt_rank, d_inner).
    ``reduce`` is applied to ``x @ x_proj`` before it is split (a
    tensor-parallel rank's partial sums are all-reduced there)."""
    dt_rank = x_proj.shape[1] - 2 * d_state
    x_dbl = x @ x_proj.to(x.dtype)
    if reduce is not None:
        x_dbl = reduce(x_dbl)
    dt = x_dbl[..., :dt_rank] @ dt_proj.to(x.dtype)
    return (dt, x_dbl[..., dt_rank:dt_rank + d_state],
            x_dbl[..., dt_rank + d_state:])


def mamba_inner(xz, conv_weight, conv_bias, x_proj, dt_proj, dt_bias, A,
                D_skip, *, d_state, impl="auto", chunk_size=128, reduce=None):
    """One Mamba direction on a pre-projected sequence.

    xz: (batch, L, 2*d_inner) — in_proj output, [x | z] halves;
    conv_weight: (width, d_inner); conv_bias: (d_inner,) or None;
    x_proj: (d_inner, dt_rank + 2*d_state); dt_proj: (dt_rank, d_inner);
    dt_bias: (d_inner,) float32; A: (d_inner, d_state); D_skip: (d_inner,).
    ``impl``: "auto", "pallas", "fused", "chunked", "ref" or "mxu" (see the
    module note). ``reduce``: ``projections``'. Returns (batch, L,
    d_inner) in xz.dtype, gated, before out_proj.
    """
    d_inner = xz.shape[-1] // 2
    x, z = xz[..., :d_inner], xz[..., d_inner:]
    x = causal_conv1d(x, conv_weight, conv_bias, activation="silu")
    dt, B, C = projections(x, x_proj, dt_proj, d_state, reduce)
    use_fused = impl == "fused" or (impl in ("auto", "pallas")
                                    and xz.device.type == "cuda")
    if use_fused and dt_bias is not None and D_skip is not None:
        return scan_fused.mamba_scan_fused(x, dt, z, A, B, C, D_skip, dt_bias,
                                           chunk_size=chunk_size)
    return selective_scan(x, dt, A, B, C, D=D_skip, z=z, delta_bias=dt_bias,
                          delta_softplus=True, impl=impl,
                          chunk_size=chunk_size)
