"""Single-step SSM recurrence for autoregressive decoding, plain PyTorch.

Port of ``segmamba_tpu/ops/selective_state_update.py`` (an XLA composition
in the JAX package, not a Pallas kernel)::

    dt    = softplus(dt + dt_bias)            (optional)
    state = state * exp(dt * A) + dt * B * x
    y     = sum_n C_n * state_n + D * x
    out   = y * silu(z)                       (optional)

Functional: returns (out, new_state) and leaves ``state`` as it is.
"""

from __future__ import annotations

import torch

from segmamba_tpu_torch.ops.selective_scan import softplus


def selective_state_update(state, x, dt, A, B, C, D=None, z=None,
                           dt_bias=None, dt_softplus=False):
    """state: (batch, dim, N) running state; x, dt, z: (batch, dim);
    A: (dim, N); B, C: (batch, N); D, dt_bias: (dim,). Returns (out
    (batch, dim) in x.dtype, new_state in state.dtype), float32 math."""
    xf = x.float()
    d = dt.float()
    if dt_bias is not None:
        d = d + dt_bias.float()
    if dt_softplus:
        d = softplus(d)
    dA = torch.exp(d[..., None] * A.float())                 # (b, dim, N)
    dBx = d[..., None] * B.float()[:, None, :] * xf[..., None]
    new_state = state.float() * dA + dBx
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + D.float() * xf
    if z is not None:
        zf = z.float()
        y = y * (zf * torch.sigmoid(zf))
    return y.to(x.dtype), new_state.to(state.dtype)
