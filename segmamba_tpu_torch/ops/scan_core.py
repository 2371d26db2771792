"""Generic selective-scan core (K6), forward and backward.

Port of ``segmamba_tpu/ops/scan_pallas.py`` ``selective_scan_pallas``
(:361-409) and its custom VJP (``_make_core`` :333-353). The Pallas kernels
``_fwd_kernel`` (:162) and ``_bwd_kernel`` (:194) run here as the
hand-written Hopper templates ``csrc/gated_scan_fwd.cu`` and
``csrc/gated_scan_bwd.cu`` in their K6 mode (``softplus=False``: delta is
final, no gate, no acc, no D, float32), launched through ``scan_dir``'s
launchers::

    (u, delta, A, B, C) -> (y, chunk exit states),  y_t = C_t . x_t

As in JAX, u, delta, A, B and C go to float32 before the kernel, bias and
softplus run before it and the D-skip and ``silu(z)`` gate after it, in
plain torch (so autograd differentiates them). The last state is the last
chunk's exit state, exact at a ragged L: the kernel stops at the last real
step, as JAX's padding with delta = 0 (identity steps) does.

- ``selective_scan_kernel`` takes CPU tensors to the plain versions and
  CUDA tensors to the kernels; any other device raises. There is no
  fallback. The templates are built for N = 16 states; another N (up to
  256, as JAX) runs as ceil(N / 16) launches over groups of 16 states: the
  states are independent given u and delta, so y is the sum of the groups'
  y, and the state axis is padded with zero B and C columns (a padded
  state stays 0 and adds nothing; its A is -1, and its gradients are
  cropped). With grad enabled it goes through ``_ScanCore`` (a
  ``torch.autograd.Function``) whose backward takes ``dy`` and ``dlast``,
  the gradient of the returned last state, which seeds the adjoint carry
  entering the last chunk (JAX :200-203).
- ``selective_scan_core_ref`` is the plain forward (the chunked doubling
  core of ``selective_scan.py``); ``selective_scan_core_bwd_ref`` the plain
  backward, ``autograd.grad`` through it.
- ``LAUNCHES`` / ``BWD_LAUNCHES`` count this wrapper's kernel launches.
"""

from __future__ import annotations

import torch

from segmamba_tpu_torch.ops import scan_dir
from segmamba_tpu_torch.ops.selective_scan import (
    _core_chunked,
    _postprocess,
    _preprocess_delta,
)

LAUNCHES = 0
BWD_LAUNCHES = 0
DEF_CHUNK = 128
_GROUP = scan_dir._KERNEL_N     # states per launch


def _last_state(states):
    """Chunk exit states (R, nc, N, D) -> last state (R, D, N)."""
    return states[:, -1].transpose(-1, -2).contiguous()


def selective_scan_core_ref(u, delta, A, B, C, chunk_size=DEF_CHUNK,
                            return_states=False):
    """Plain PyTorch version of the K6 core on float32 operands: u, delta
    (R, L, D), A (D, N) or (R, D, N), B, C (R, L, N). Returns (y, last
    state (R, D, N)), or with ``return_states`` (y, chunk exit states
    (R, nc, N, D)), chunks cut at multiples of ``min(chunk_size, L)``."""
    T = min(chunk_size, u.shape[1])
    y, states = _core_chunked(u, delta, A, B, C, chunk_size=T,
                              return_chunk_states=True)
    return (y, states) if return_states else (y, _last_state(states))


def selective_scan_core_bwd_ref(u, delta, A, B, C, dy, dlast,
                                chunk_size=DEF_CHUNK):
    """Plain backward of the K6 core: ``autograd.grad`` of (y, last state)
    through ``selective_scan_core_ref`` with cotangents (dy, dlast), in
    float32. Returns (du, ddelta, dA, dB, dC) in the inputs' shapes."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_()
                  for t in (u, delta, A, B, C)]
        y, last = selective_scan_core_ref(*leaves, chunk_size=chunk_size)
        return torch.autograd.grad((y, last), leaves,
                                   (dy.float(), dlast.float()))


def _zeros_param(u):
    """The templates' D and bias, zero in K6's mode."""
    return torch.zeros(u.shape[-1], dtype=torch.float32, device=u.device)


_groups = scan_dir._groups             # launches per call
_pad_states = scan_dir._pad_states     # state axis to a multiple of 16


def _group_forward(A, B, C, launch):
    """A 16-state forward kernel over ceil(N / 16) groups of states:
    ``launch(A_g, B_g, C_g, g)`` -> (y_g, chunk exit states_g). Returns
    (y, chunk exit states (R, nc, N, D)): y is the groups' sum, the states
    are concatenated and cropped to N."""
    N = A.shape[-1]
    A, B, C = _pad_states(A, B, C)
    y, states = None, []
    for g in range(_groups(N)):
        sl = slice(g * _GROUP, (g + 1) * _GROUP)
        y_g, st = launch(A[..., sl], B[..., sl], C[..., sl], g)
        y = y_g if y is None else y + y_g
        states.append(st)
    states = states[0] if len(states) == 1 else torch.cat(states, 2)
    return y, states[:, :, :N]


def _group_backward(A, B, C, dlast, states, launch):
    """The matching backward: ``launch(A_g, B_g, C_g, dlast_g (R, 16, D),
    states_g, g)`` -> (du, ddelta, dA_g, dB_g, dC_g) of one group. Returns
    (du, ddelta, dA, dB, dC): du and ddelta summed over the groups, the
    others concatenated and cropped to N."""
    N = A.shape[-1]
    A, B, C = _pad_states(A, B, C)
    pad = A.shape[-1] - N
    dlast = dlast.float().transpose(-1, -2)                  # (R, N, D)
    if pad:   # the padded states' exit states are 0
        states = torch.nn.functional.pad(states, (0, 0, 0, pad))
        dlast = torch.nn.functional.pad(dlast, (0, 0, 0, pad))
    du = ddelta = None
    dA, dB, dC = [], [], []
    for g in range(_groups(N)):
        sl = slice(g * _GROUP, (g + 1) * _GROUP)
        du_g, ddelta_g, dA_g, dB_g, dC_g = launch(
            A[..., sl], B[..., sl], C[..., sl], dlast[:, sl].contiguous(),
            states[:, :, sl].contiguous(), g)
        du = du_g if du is None else du + du_g
        ddelta = ddelta_g if ddelta is None else ddelta + ddelta_g
        dA.append(dA_g)
        dB.append(dB_g)
        dC.append(dC_g)
    cat = lambda ts: (ts[0] if len(ts) == 1 else torch.cat(ts, -1))[..., :N]
    return du, ddelta, cat(dA), cat(dB), cat(dC)


def _launch(u, delta, A, B, C, chunk_size):
    """K6 forward on the card: (y, chunk exit states (R, nc, N, D)), one
    launch per group of 16 states."""
    z = _zeros_param(u)
    return _group_forward(A, B, C, lambda A_g, B_g, C_g, g: scan_dir._launch(
        u, delta, None, None, A_g, B_g, C_g, z, z, reverse=False, gate=False,
        chunk_size=chunk_size, return_states=True, softplus=False))


def _launch_bwd(u, delta, A, B, C, dy, dlast, states, chunk_size):
    """K6 backward on the card: (du, ddelta, dA, dB, dC), one launch per
    group of 16 states."""
    z = _zeros_param(u)

    def launch(A_g, B_g, C_g, dlast_g, states_g, g):
        grads = scan_dir._launch_bwd(
            u, delta, None, None, A_g, B_g, C_g, z, z, dy, states_g,
            reverse=False, gate=False, chunk_size=chunk_size, softplus=False,
            dlast=dlast_g)
        return grads[0], grads[1], grads[4], grads[5], grads[6]

    return _group_backward(A, B, C, dlast, states, launch)


def _forward(u, delta, A, B, C, chunk_size):
    """(y, chunk exit states): the kernel for CUDA tensors (counted), the
    plain version for CPU tensors."""
    global LAUNCHES
    if u.device.type == "cpu":
        return selective_scan_core_ref(u, delta, A, B, C, chunk_size,
                                       return_states=True)
    out = _launch(u, delta, A, B, C, chunk_size)
    LAUNCHES += _groups(A.shape[-1])
    return out


class _ScanCore(torch.autograd.Function):
    """The K6 core with its backward (the custom VJP of the JAX package's
    ``scan_pallas._make_core``). CUDA tensors run the kernels, CPU tensors
    the plain versions; outputs (y, last state)."""

    @staticmethod
    def forward(ctx, chunk_size, u, delta, A, B, C):
        y, states = _forward(u, delta, A, B, C, chunk_size)
        ctx.chunk_size = chunk_size
        ctx.save_for_backward(u, delta, A, B, C, states)
        return y, _last_state(states)

    @staticmethod
    def backward(ctx, dy, dlast):
        global BWD_LAUNCHES
        u, delta, A, B, C, states = ctx.saved_tensors
        if u.device.type == "cpu":
            grads = selective_scan_core_bwd_ref(u, delta, A, B, C, dy, dlast,
                                                ctx.chunk_size)
        else:
            grads = _launch_bwd(u, delta, A, B, C, dy, dlast, states,
                                ctx.chunk_size)
            BWD_LAUNCHES += _groups(A.shape[-1])
        return (None,) + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[1:]))


def _core(u, delta, A, B, C, chunk_size):
    """Route one core call: through ``_ScanCore`` when a gradient is to be
    recorded, else straight to the kernel (CUDA) or the plain forward
    (CPU). Returns (y, last state (R, D, N))."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, delta, A, B, C)):
        return _ScanCore.apply(chunk_size, u, delta, A, B, C)
    y, states = _forward(u, delta, A, B, C, chunk_size)
    return y, _last_state(states)


def selective_scan_kernel(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                          delta_softplus=False, return_last_state=False,
                          chunk_size=DEF_CHUNK):
    """Selective scan through the K6 core; the contract of
    ``selective_scan_pallas``: time-major u, delta, z (batch, L, dim),
    time-varying B, C (batch, L, N), A (dim, N) or (batch, dim, N), D and
    delta_bias (dim,) or (batch, dim). Returns out (batch, L, dim) in
    u.dtype, and the float32 last state (batch, dim, N) with
    ``return_last_state``.

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    (one launch per 16 states, N <= 256). Differentiable in every tensor
    argument.
    """
    if B.dim() != 3 or C.dim() != 3:
        raise ValueError("the scan kernel needs time-varying (batch, L, N) "
                         "B and C")
    if A.shape[-1] > 256:
        raise ValueError(f"dstate must be <= 256, got {A.shape[-1]}")
    d = _preprocess_delta(delta, delta_bias, delta_softplus)
    y, last = _core(u.float(), d, A.float(), B.float(), C.float(),
                    chunk_size)
    out = _postprocess(y, u, D, z, u.dtype)
    return (out, last) if return_last_state else out
