"""Selective SSM scan: the plain PyTorch cores and the dispatcher.

Port of ``segmamba_tpu/ops/selective_scan.py`` (``selective_scan_ref``,
``_core_ref``, ``_core_chunked``, ``_expand_groups``, ``_wdtype``,
``_preprocess_delta``, ``_postprocess`` and the ``selective_scan``
dispatcher). Per batch row, channel ``d``, state ``n`` and step ``t``::

    delta = softplus(delta_raw + delta_bias)           (optional)
    x[t]  = exp(delta[t] * A) * x[t-1] + delta[t] * B[t] * u[t]
    y[t]  = sum_n C[t, n] * x[t, n]  (+ D * u[t])
    out   = y * silu(z)                                (optional gate)

Time-major like the JAX package: sequences ``(batch, L, dim)``. ``A`` may be
shared ``(dim, N)`` or per-row ``(batch, dim, N)``. B and C may be
time-varying ``(batch, L, N)``, grouped ``(batch, L, G, N)`` (channel ``d``
uses group ``d // (dim / G)``) or static ``(dim, N)``; A, B and C may be
complex (complex64 weights, output folded as ``2 Re``), as the reference CUDA
op allows. The recurrence runs in float32 (complex64 with complex weights)
whatever the input dtype; the output is cast back to ``u.dtype``.

These cores are the plain versions the scan kernel's wrappers
(``scan_dir.py``, ``scan_fused.py``, ``scan_core.py``) use for CPU tensors
and are compared with on the card.
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


def _wdtype(*ts):
    """Weight compute dtype: complex64 if any operand is complex (the CUDA
    op's complex-weight path), else float32."""
    return (torch.complex64 if any(t.is_complex() for t in ts)
            else torch.float32)


def _expand_groups(M, dim):
    """Grouped (batch, L, G, N) -> per-channel (batch, L, dim, N),
    group-major: channel d uses group d // (dim / G)."""
    G = M.shape[2]
    if dim % G:
        raise ValueError(f"dim={dim} not divisible by n_groups={G}")
    return M.repeat_interleave(dim // G, dim=2)


def _per_step(M):
    """B or C -> broadcastable against (batch, L, dim, N): static (dim, N)
    as is, time-varying (batch, L, N) with a channel axis, per-channel
    (batch, L, dim, N) as is."""
    return M[:, :, None, :] if M.dim() == 3 else M


def _contract_c(x, C, shared):
    """y = sum_n C x over (..., dim, N) states. ``shared``: C is (..., N),
    one row for every channel (time-varying B/C, cut to x's leading axes);
    else C broadcasts against x (static (dim, N) or per-channel)."""
    C = C.to(x.dtype)
    if shared:
        return torch.einsum("...dn,...n->...d", x, C)
    return (x * C).sum(-1)


def _fold(y):
    """The reference's complex-output fold: 2 Re(y)."""
    return 2.0 * y.real if y.is_complex() else y


def _core_ref(u, delta, A, B, C):
    """Sequential loop over time (test oracle, small L). u/delta: (b, L, D)
    f32; A: (D, N) or (b, D, N); B, C: (b, L, N), (b, L, G, N) or (D, N),
    real or complex. Returns (y, last_state)."""
    batch, seqlen, dim = u.shape
    dstate = A.shape[-1]
    B, C = (_expand_groups(M, dim) if M.dim() == 4 else M for M in (B, C))
    Ab = A[:, None] if A.dim() == 3 else A[None, None]       # (b|1, 1, D, N)
    x = torch.zeros(batch, dim, dstate, dtype=_wdtype(A, B, C),
                    device=u.device)
    at = lambda M, t: M if M.dim() == 2 else _per_step(M)[:, t]
    ys = []
    for t in range(seqlen):
        a = torch.exp(delta[:, t, :, None] * Ab[:, 0])
        b = (delta[:, t] * u[:, t])[..., None] * at(B, t)
        x = a * x + b
        ys.append(_contract_c(x, C if C.dim() == 2 else C[:, t],
                              C.dim() == 3))
    return _fold(torch.stack(ys, dim=1)), x


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
    step. B and C as ``_core_ref`` takes them. Returns (y (b, L, D),
    last_state (b, D, N)), or with ``return_chunk_states`` (y, exit states
    (b, nc, N, D)) in the kernel's layout.
    """
    batch, seqlen, dim = u.shape
    dstate = A.shape[-1]
    B, C = (_expand_groups(M, dim) if M.dim() == 4 else M for M in (B, C))
    T = min(chunk_size, max(seqlen, 1))
    pad = (-seqlen) % T
    if pad:
        # time is axis 1 of the sequences and of time-varying B/C
        zpad = lambda t: (t if t.dim() == 2 else torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)))
        u, delta, B, C = zpad(u), zpad(delta), zpad(B), zpad(C)
    L = seqlen + pad
    nc = L // T

    a = torch.exp(delta[..., None] * _per_row(A))            # (b, L, D, N)
    b = (delta * u)[..., None] * _per_step(B)
    a = a.reshape(batch, nc, T, dim, dstate)
    b = b.reshape(batch, nc, T, dim, dstate)
    a_cum, b_cum = _hs_scan(a, b, dim=2)
    _, carry = _hs_scan(a_cum[:, :, -1], b_cum[:, :, -1], dim=1)  # exits
    entry = torch.cat([torch.zeros_like(carry[:, :1]), carry[:, :-1]], 1)
    x = b_cum + a_cum * entry[:, :, None]                    # (b, nc, T, D, N)
    Cc = C if C.dim() == 2 else C.reshape(batch, nc, T, *C.shape[2:])
    y = _fold(_contract_c(x, Cc, C.dim() == 3)).reshape(batch, L, dim)
    y = y[:, :seqlen]
    if return_chunk_states:
        return y, carry.transpose(-1, -2).contiguous()
    return y, carry[:, -1]


def _weights(*ts):
    """Each of A, B, C in its own weight dtype (float32 or complex64)."""
    return tuple(t.to(_wdtype(t)) for t in ts)


def selective_scan_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, return_last_state=False):
    """Exact sequential selective scan (test oracle).

    u, delta: (batch, L, dim); A: (dim, N) or (batch, dim, N), real or
    complex; B, C: (batch, L, N), (batch, L, G, N) or (dim, N), real or
    complex; D, delta_bias: (dim,) or (batch, dim); z: (batch, L, dim) or
    None. Returns out (batch, L, dim) in u.dtype, and the last state
    (batch, dim, N) if ``return_last_state`` (complex when the weights are).
    """
    d = _preprocess_delta(delta, delta_bias, delta_softplus)
    y, last = _core_ref(u.float(), d, *_weights(A, B, C))
    out = _postprocess(y, u, D, z, u.dtype)
    return (out, last) if return_last_state else out


def selective_scan_chunked(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                           delta_softplus=False, return_last_state=False,
                           chunk_size=128):
    """Chunked doubling-scan selective scan; same surface as
    ``selective_scan_ref``, grouped, static and complex B/C included."""
    d = _preprocess_delta(delta, delta_bias, delta_softplus)
    y, last = _core_chunked(u.float(), d, *_weights(A, B, C),
                            chunk_size=chunk_size)
    out = _postprocess(y, u, D, z, u.dtype)
    return (out, last) if return_last_state else out


IMPLS = ("auto", "pallas", "chunked", "ref", "mxu")


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False,
                   impl="auto", chunk_size=128):
    """Selective scan with implementation dispatch, by the JAX package's
    ``impl`` names:

    - ``"auto"``: the hand-written kernel (``scan_core``, K6) for CUDA
      tensors, the chunked plain core for CPU tensors;
    - ``"pallas"``: ``scan_core.selective_scan_kernel`` on either device
      (the kernel on CUDA, its chunked plain version on the CPU);
    - ``"chunked"`` / ``"ref"``: the plain cores;
    - ``"mxu"``: ``scan_mxu.selective_scan_mxu`` on either device (the
      ratio-form kernel K7 on CUDA, its plain version on the CPU).

    Grouped, static or complex B/C take the chunked plain core on either
    device, whatever the impl, as the JAX dispatcher sends them to its XLA
    core (JAX ``selective_scan.py:267-273``); they are tested first.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown selective_scan impl: {impl!r}")
    on_card = u.device.type == "cuda"
    if impl in ("auto", "pallas", "mxu") and (
            B.dim() != 3 or C.dim() != 3
            or any(t.is_complex() for t in (A, B, C))):
        impl = "chunked"
    if impl == "mxu":
        from segmamba_tpu_torch.ops import scan_mxu   # imports this module
        return scan_mxu.selective_scan_mxu(
            u, delta, A, B, C, D, z, delta_bias, delta_softplus,
            return_last_state, chunk_size=chunk_size)
    if impl == "auto":
        impl = "pallas" if on_card else "chunked"
    if impl == "ref":
        return selective_scan_ref(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus, return_last_state)
    if impl == "chunked":
        return selective_scan_chunked(u, delta, A, B, C, D, z, delta_bias,
                                      delta_softplus, return_last_state,
                                      chunk_size=chunk_size)
    from segmamba_tpu_torch.ops import scan_core   # imports this module
    return scan_core.selective_scan_kernel(
        u, delta, A, B, C, D, z, delta_bias, delta_softplus,
        return_last_state, chunk_size=chunk_size)
