"""Fused gated selective scan, forward: one pass over the sequence.

Port of ``segmamba_tpu/ops/scan_pallas_fused.py`` ``mamba_scan_fused``
(:250-306), whose Pallas kernel ``_fwd_kernel`` (:42) runs here as the
hand-written Hopper kernel ``csrc/gated_scan_fwd.cu`` with REVERSE=0,
GATE=1, HAS_ACC=0::

    out = (scan(u, softplus(dt + dt_bias), A, B, C) + D u) * silu(z)

- ``mamba_scan_fused`` takes CPU tensors to the plain version and CUDA
  tensors to the kernel; any other device raises. There is no fallback.
- ``mamba_scan_fused_ref`` is the plain PyTorch version.
- ``LAUNCHES`` counts this wrapper's kernel launches.
"""

from __future__ import annotations

from segmamba_tpu_torch.ops.scan_dir import (
    DEF_CHUNK,
    _launch,
    mamba_scan_fused_dir_ref,
)

LAUNCHES = 0


def mamba_scan_fused_ref(u, dt, z, A, B, C, D, dt_bias, chunk_size=DEF_CHUNK,
                         return_states=False):
    """Plain PyTorch version of ``mamba_scan_fused``."""
    return mamba_scan_fused_dir_ref(u, dt, z, A, B, C, D, dt_bias, gate=True,
                                    chunk_size=chunk_size,
                                    return_states=return_states)


def mamba_scan_fused(u, dt, z, A, B, C, D, dt_bias, chunk_size=DEF_CHUNK,
                     return_states=False):
    """out = (scan(u, softplus(dt + bias), A, B, C) + D u) * silu(z).

    u/dt/z: (R, L, dim) in one storage dtype (float32 or bfloat16);
    B/C: (R, L, N) in that dtype (N = 16 on the kernel). Parameters are
    shared — A: (dim, N), D/dt_bias: (dim,) — or per row — A: (R, dim, N),
    D/dt_bias: (R, dim). Returns (R, L, dim) in u.dtype, and with
    ``return_states`` the float32 chunk exit states (R, nc, N, dim).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if u.device.type == "cpu":
        return mamba_scan_fused_ref(u, dt, z, A, B, C, D, dt_bias,
                                    chunk_size=chunk_size,
                                    return_states=return_states)
    global LAUNCHES
    result = _launch(u, dt, z, None, A, B, C, D, dt_bias, reverse=False,
                     gate=True, chunk_size=chunk_size,
                     return_states=return_states)
    LAUNCHES += 1
    return result
