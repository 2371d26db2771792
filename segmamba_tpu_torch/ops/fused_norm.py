"""Residual add + LayerNorm / RMSNorm, plain PyTorch.

Port of ``segmamba_tpu/ops/fused_norm.py`` (XLA compositions in the JAX
package, not Pallas kernels): the same call surface, ``prenorm`` returning
the updated residual and ``residual_in_fp32`` keeping it in float32.
Statistics and the add run in float32.
"""

from __future__ import annotations

import torch


def _norm(x, weight, bias, eps, is_rms):
    if is_rms:
        normed = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    else:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        normed = (x - mean) * torch.rsqrt(var + eps)
    out = normed * weight.float()
    return out if bias is None else out + bias.float()


def layer_norm_fn(x, weight, bias=None, residual=None, prenorm=False,
                  residual_in_fp32=False, eps=1e-6, is_rms_norm=False):
    """y = norm(x + residual) in x.dtype; with ``prenorm`` also the new
    residual (float32 with ``residual_in_fp32``, else x.dtype)."""
    res = x.float() if residual is None else x.float() + residual.float()
    out = _norm(res, weight, bias, eps, is_rms_norm).to(x.dtype)
    if prenorm:
        return out, (res if residual_in_fp32 else res.to(x.dtype))
    return out


def rms_norm_fn(x, weight, bias=None, residual=None, prenorm=False,
                residual_in_fp32=False, eps=1e-6):
    return layer_norm_fn(x, weight, bias, residual, prenorm,
                         residual_in_fp32, eps, is_rms_norm=True)
