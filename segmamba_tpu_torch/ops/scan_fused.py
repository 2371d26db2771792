"""Fused gated selective scan, forward and backward: one pass over the
sequence each way.

Port of ``segmamba_tpu/ops/scan_pallas_fused.py`` ``mamba_scan_fused``
(:250-306) and its custom VJP (``_make_core`` :225-247), whose Pallas
kernels ``_fwd_kernel`` (:42) and ``_bwd_kernel`` (:73) run here as the
hand-written Hopper kernels ``csrc/gated_scan_fwd.cu`` and
``csrc/gated_scan_bwd.cu`` with REVERSE=0, GATE=1, HAS_ACC=0::

    out = (scan(u, softplus(dt + dt_bias), A, B, C) + D u) * silu(z)

- ``mamba_scan_fused`` takes CPU tensors to the plain versions and CUDA
  tensors to the kernels; any other device raises. There is no fallback.
  With grad enabled it is differentiable through ``scan_dir._GatedScan``.
- ``mamba_scan_fused_ref`` / ``mamba_scan_fused_bwd_ref`` are the plain
  PyTorch forward and backward.
- ``LAUNCHES`` / ``BWD_LAUNCHES`` count this wrapper's kernel launches.
"""

from __future__ import annotations

import sys

from segmamba_tpu_torch.ops.scan_dir import (
    DEF_CHUNK,
    _scan,
    mamba_scan_fused_dir_bwd_ref,
    mamba_scan_fused_dir_ref,
)

LAUNCHES = 0
BWD_LAUNCHES = 0


def mamba_scan_fused_ref(u, dt, z, A, B, C, D, dt_bias, chunk_size=DEF_CHUNK,
                         return_states=False):
    """Plain PyTorch version of ``mamba_scan_fused``."""
    return mamba_scan_fused_dir_ref(u, dt, z, A, B, C, D, dt_bias, gate=True,
                                    chunk_size=chunk_size,
                                    return_states=return_states)


def mamba_scan_fused_bwd_ref(u, dt, z, A, B, C, D, dt_bias, dout,
                             chunk_size=DEF_CHUNK):
    """Plain PyTorch backward of ``mamba_scan_fused``: (du, ddt, dz, None,
    dA, dB, dC, dD, dbias), float32, in the inputs' shapes (shared
    parameters summed over rows), as ``mamba_scan_fused_dir_bwd_ref``."""
    return mamba_scan_fused_dir_bwd_ref(u, dt, z, A, B, C, D, dt_bias, dout,
                                        gate=True, chunk_size=chunk_size)


def mamba_scan_fused(u, dt, z, A, B, C, D, dt_bias, chunk_size=DEF_CHUNK,
                     return_states=False):
    """out = (scan(u, softplus(dt + bias), A, B, C) + D u) * silu(z).

    u/dt/z: (R, L, dim) in one storage dtype (float32 or bfloat16);
    B/C: (R, L, N) in that dtype (N = 16 on the kernel). Parameters are
    shared — A: (dim, N), D/dt_bias: (dim,) — or per row — A: (R, dim, N),
    D/dt_bias: (R, dim). Returns (R, L, dim) in u.dtype, and with
    ``return_states`` the float32 chunk exit states (R, nc, N, dim).

    CPU tensors run the plain versions; CUDA tensors launch the kernels.
    Differentiable in every tensor argument.
    """
    return _scan(sys.modules[__name__], u, dt, z, None, A, B, C, D, dt_bias,
                 reverse=False, gate=True, chunk_size=chunk_size,
                 return_states=return_states)
