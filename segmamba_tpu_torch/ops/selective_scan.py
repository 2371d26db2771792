"""Selective SSM scan in plain PyTorch.

Port of ``segmamba_tpu/ops/selective_scan.py`` (``selective_scan_ref``,
``_core_ref``, ``_core_chunked``, ``_preprocess_delta``, ``_postprocess``)
for real, time-varying ``(batch, L, N)`` B/C. Per batch row, channel ``d``,
state ``n`` and step ``t``::

    delta = softplus(delta_raw + delta_bias)           (optional)
    x[t]  = exp(delta[t] * A) * x[t-1] + delta[t] * B[t] * u[t]
    y[t]  = sum_n C[t, n] * x[t, n]  (+ D * u[t])
    out   = y * silu(z)                                (optional gate)

Time-major like the JAX package: sequences ``(batch, L, dim)``. ``A`` may be
shared ``(dim, N)`` or per-row ``(batch, dim, N)``. The recurrence runs in
float32 whatever the input dtype; the output is cast back to ``u.dtype``.

These cores are the plain versions the scan kernel's wrappers
(``scan_dir.py``, ``scan_fused.py``) use for CPU tensors and are compared
with on the card.
"""

from __future__ import annotations

import torch


def softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)`` — JAX's ``jax.nn.softplus``
    form, finite for large ``x`` (no threshold switch). ``max(x, 0)`` is
    ``torch.maximum``, which splits a tie's gradient, so that autograd gives
    sigmoid(0) = 0.5 at x = 0 exactly, as JAX does (``clamp_min`` gives 1)."""
    return (torch.maximum(x, torch.zeros_like(x))
            + torch.log1p(torch.exp(-x.abs())))


def _preprocess_delta(delta, delta_bias, delta_softplus):
    """float32 delta, plus bias, optional softplus. ``delta_bias`` is
    ``(dim,)`` or per-row ``(batch, dim)``."""
    delta = delta.float()
    if delta_bias is not None:
        bias = delta_bias.float()
        delta = delta + (bias[:, None, :] if bias.dim() == 2 else bias)
    if delta_softplus:
        delta = softplus(delta)
    return delta


def _postprocess(y, u, D, z, out_dtype):
    """D skip connection and silu(z) gate, then cast to ``out_dtype``.
    ``D`` is ``(dim,)`` or per-row ``(batch, dim)``."""
    if D is not None:
        Df = D.float()
        y = y + u.float() * (Df[:, None, :] if Df.dim() == 2 else Df)
    if z is not None:
        zf = z.float()
        y = y * (zf * torch.sigmoid(zf))
    return y.to(out_dtype)


def _per_row(A):
    """(dim, N) or (batch, dim, N) -> broadcastable against (batch, L, dim, N)."""
    return A[:, None] if A.dim() == 3 else A


def _core_ref(u, delta, A, B, C):
    """Sequential loop over time (test oracle, small L). u/delta: (b, L, D)
    f32; A: (D, N) or (b, D, N); B, C: (b, L, N). Returns (y, last_state)."""
    batch, seqlen, dim = u.shape
    dstate = A.shape[-1]
    Ab = A[:, None] if A.dim() == 3 else A[None, None]       # (b|1, 1, D, N)
    x = torch.zeros(batch, dim, dstate, dtype=torch.float32, device=u.device)
    ys = []
    for t in range(seqlen):
        a = torch.exp(delta[:, t, :, None] * Ab[:, 0])
        b = (delta[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        x = a * x + b
        ys.append(torch.einsum("bdn,bn->bd", x, C[:, t]))
    return torch.stack(ys, dim=1), x


def _hs_scan(a, b, dim):
    """Inclusive scan of the first-order recurrence x[t] = a[t] x[t-1] + b[t]
    along ``dim`` by Hillis–Steele doubling: log2(n) combines of
    (a, b) o (a', b') = (a'a, a'b + b'). Only products of the a's (decays in
    (0, 1]) are formed, never their inverses, so nothing overflows."""
    n = a.shape[dim]
    k = 1
    while k < n:
        a_prev, b_prev = a.narrow(dim, 0, n - k), b.narrow(dim, 0, n - k)
        a_cur, b_cur = a.narrow(dim, k, n - k), b.narrow(dim, k, n - k)
        b = torch.cat([b.narrow(dim, 0, k), a_cur * b_prev + b_cur], dim)
        a = torch.cat([a.narrow(dim, 0, k), a_cur * a_prev], dim)
        k *= 2
    return a, b


def _core_chunked(u, delta, A, B, C, chunk_size=128,
                  return_chunk_states=False):
    """Two-level chunked scan: in-chunk doubling scan, then a doubling scan
    of the chunk-exit states, then each chunk's states from its entry state.

    The ragged tail is padded with identity steps (delta = 0 => a = 1,
    b = 0), so the last chunk's exit state is the state at the last real
    step. Returns (y (b, L, D), last_state (b, D, N)), or with
    ``return_chunk_states`` (y, exit states (b, nc, N, D)) in the kernel's
    layout.
    """
    batch, seqlen, dim = u.shape
    dstate = A.shape[-1]
    T = min(chunk_size, max(seqlen, 1))
    pad = (-seqlen) % T
    if pad:
        zpad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
        u, delta, B, C = zpad(u), zpad(delta), zpad(B), zpad(C)
    L = seqlen + pad
    nc = L // T

    a = torch.exp(delta[..., None] * _per_row(A))            # (b, L, D, N)
    b = (delta * u)[..., None] * B[:, :, None, :]
    a = a.reshape(batch, nc, T, dim, dstate)
    b = b.reshape(batch, nc, T, dim, dstate)
    a_cum, b_cum = _hs_scan(a, b, dim=2)
    _, carry = _hs_scan(a_cum[:, :, -1], b_cum[:, :, -1], dim=1)  # exits
    entry = torch.cat([torch.zeros_like(carry[:, :1]), carry[:, :-1]], 1)
    x = b_cum + a_cum * entry[:, :, None]                    # (b, nc, T, D, N)
    y = torch.einsum("bctdn,bctn->bctd", x,
                     C.reshape(batch, nc, T, dstate)).reshape(batch, L, dim)
    y = y[:, :seqlen]
    if return_chunk_states:
        return y, carry.transpose(-1, -2).contiguous()
    return y, carry[:, -1]


def selective_scan_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, return_last_state=False):
    """Exact sequential selective scan (test oracle).

    u, delta: (batch, L, dim); A: (dim, N) or (batch, dim, N);
    B, C: (batch, L, N); D, delta_bias: (dim,) or (batch, dim);
    z: (batch, L, dim) or None. Returns out (batch, L, dim) in u.dtype, and
    the last state (batch, dim, N) if ``return_last_state``.
    """
    d = _preprocess_delta(delta, delta_bias, delta_softplus)
    y, last = _core_ref(u.float(), d, A.float(), B.float(), C.float())
    out = _postprocess(y, u, D, z, u.dtype)
    return (out, last) if return_last_state else out


def selective_scan_chunked(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                           delta_softplus=False, return_last_state=False,
                           chunk_size=128):
    """Chunked doubling-scan selective scan; same surface as
    ``selective_scan_ref``."""
    d = _preprocess_delta(delta, delta_bias, delta_softplus)
    y, last = _core_chunked(u.float(), d, A.float(), B.float(), C.float(),
                            chunk_size=chunk_size)
    out = _postprocess(y, u, D, z, u.dtype)
    return (out, last) if return_last_state else out
