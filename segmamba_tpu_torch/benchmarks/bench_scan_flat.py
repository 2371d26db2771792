"""The fused forward scan with its states spread over threads (K11): twin of
``benchmarks/bench_scan_flat.py``.

K11 computes K2's function from a zero state::

    out = (scan(u, softplus(dt + dt_bias), A, B, C) + D u) * silu(z)

in the TPU script's flat layout: one working element per (state,
channel). On the TPU that is one (T, N D) array whose lane dim fills whole
128-lane groups; on the card it is one thread per (state, channel), a
channel's 16 states on 16 lanes (``csrc/scan_flat_fwd.cu``), against K2's
8 states per thread. ``main`` is the A/B the JAX script ran.

- ``flat_call`` takes CPU tensors to ``flat_call_ref`` and CUDA tensors to
  the kernel; any other device raises. There is no fallback. L must be a
  multiple of T (the JAX entry drops the tail); the kernel takes T = 128.
- ``flat_call_ref`` is the plain PyTorch version in the flat layout: per
  chunk, (R, T, N dim) arrays with lane n dim + d; ``_hs_fwd_flat``'s
  doubling combine along T; the chunk carry added at step 0. The TPU
  kernel's one-hot products become an index broadcast (B expanded over the
  channels) and a sum over n (the C reduction). Its hi/lo split of the
  reduction is the identity in exact arithmetic and is not repeated; on
  the TPU the DEFAULT-precision one-hot product also truncates the B
  expansion to bf16 (exact for bf16 inputs, as in ``main``).
- ``LAUNCHES`` counts the kernel's launches.
- ``main`` prints the JAX script's line per batch (1 and 3): ``ref`` is
  the port's K2 (``ops.scan_fused.mamba_scan_fused``) on the same inputs,
  ``flat`` this kernel, ``x`` their ratio, ``err`` their largest
  difference::

      python -m segmamba_tpu_torch.benchmarks.bench_scan_flat
      python -m segmamba_tpu_torch.benchmarks.bench_scan_flat --device cpu \\
          --L 512 --dim 8
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from segmamba_tpu_torch.benchmarks.bench_scan_lb import (
    CHUNK,
    KERNEL_N,
    bench_inputs,
    check_cuda,
    gated_output,
    kernel_operands,
    parser,
)
from segmamba_tpu_torch.benchmarks.microbench import (
    chain_time,
    device_name,
    resolve_device,
)
from segmamba_tpu_torch.ops import _build
from segmamba_tpu_torch.ops.scan_fused import mamba_scan_fused
from segmamba_tpu_torch.ops.selective_scan import _preprocess_delta

LAUNCHES = 0
_LIB_NAME = "scan_flat_fwd"


def _shift_down(x, k, fill):
    """x shifted k steps down axis 1, the first k filled with ``fill``."""
    return F.pad(x[:, :x.shape[1] - k], (0, 0, k, 0), value=fill)


def _hs_fwd_flat(a, b, T):
    """The doubling (Hillis-Steele) combine along axis 1."""
    k = 1
    while k < T:
        b = a * _shift_down(b, k, 0.0) + b
        if 2 * k < T:
            a = a * _shift_down(a, k, 1.0)
        k *= 2
    return b


def flat_call_ref(u, dt, z, A, B, C, D, dt_bias, T=CHUNK):
    """Plain PyTorch version of ``flat_call``: u/dt/z (R, L, dim), A (dim,
    N), B/C (R, L, N), D/dt_bias (dim,); returns (R, L, dim) in u.dtype.
    The chunks run in order, each from the carry the one before it left."""
    R, L, dim = u.shape
    if L % T:
        raise ValueError(f"L = {L} is not a multiple of T = {T}")
    N = A.shape[-1]
    delta = _preprocess_delta(dt, dt_bias, True)
    uf = u.float()
    Af = A.float().t().reshape(N * dim)             # lane n dim + d
    state = torch.arange(N * dim, device=u.device) // dim   # lane's n
    out = torch.empty_like(u)
    carry = torch.zeros(R, 1, N * dim, device=u.device)
    for c in range(L // T):
        sl = slice(c * T, (c + 1) * T)
        delta_t = delta[:, sl].repeat(1, 1, N)      # (R, T, N dim)
        du_t = (delta[:, sl] * uf[:, sl]).repeat(1, 1, N)
        a = torch.exp(delta_t * Af)
        b = du_t * B[:, sl].float()[..., state]     # B expanded
        b = torch.cat([b[:, :1] + a[:, :1] * carry, b[:, 1:]], 1)
        x = _hs_fwd_flat(a, b, T)
        p = C[:, sl].float()[..., state] * x
        y = p.reshape(R, T, N, dim).sum(2)          # C reduced over n
        out[:, sl] = gated_output(y, u[:, sl], z[:, sl], D)
        carry = x[:, T - 1:T]
    return out


def flat_call(u, dt, z, A, B, C, D, dt_bias, T=CHUNK):
    """K2's function through K11: CPU tensors run ``flat_call_ref``, CUDA
    tensors the kernel; shapes as ``flat_call_ref``."""
    if u.device.type == "cpu":
        return flat_call_ref(u, dt, z, A, B, C, D, dt_bias, T)
    return _launch(u, dt, z, A, B, C, D, dt_bias, T)


def _launch(u, dt, z, A, B, C, D, dt_bias, T):
    """Launch ``scan_flat_fwd`` on the current stream of u's card."""
    global LAUNCHES
    check_cuda(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        out = _run_kernel(_lib(), stream, u, dt, z, A, B, C, D, dt_bias, T)
    LAUNCHES += 1
    return out


def _run_kernel(lib, stream, u, dt, z, A, B, C, D, dt_bias, T):
    """Validate the operands, allocate the output and the look-back's
    scratch on u's device and call the library's ``scan_flat_fwd`` on
    ``stream``: one kernel, and a zero fill of its flags and ticket before
    it on the same stream."""
    Af, Df, bf, u, dt, z, B, C = kernel_operands(u, dt, z, A, B, C, D,
                                                 dt_bias, T)
    R, L, dim = u.shape
    out = torch.empty_like(u)
    # aggregate and inclusive records, sums of delta, and the flags, the
    # first of them the chunks' ticket (zeroed here)
    sizes = (ctypes.c_longlong * 3)()
    lib.scan_flat_fwd_scratch(R, L, dim, sizes)
    n_st, n_sd, n_fl = sizes
    scratch = torch.empty(2 * n_st + n_sd, dtype=torch.float32,
                          device=u.device)
    flags = torch.zeros(n_fl, dtype=torch.int32, device=u.device)
    base = scratch.data_ptr()
    err = lib.scan_flat_fwd(
        u.data_ptr(), dt.data_ptr(), z.data_ptr(), B.data_ptr(),
        C.data_ptr(), Af.data_ptr(), Df.data_ptr(), bf.data_ptr(),
        out.data_ptr(), base, base + 4 * n_st, base + 8 * n_st,
        flags.data_ptr(), int(u.dtype == torch.bfloat16), R, L, dim,
        A.shape[-1], T, stream)
    if err != 0:
        msg = lib.scan_flat_error_string(err).decode()
        raise RuntimeError(f"scan_flat_fwd launch failed: {msg} ({err})")
    return out


_LIB = None


def _lib():
    """The kernel library with its C signatures declared (built on first
    use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load_library(_LIB_NAME)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.scan_flat_fwd.argtypes = [vp] * 13 + [i] + [ll] * 3 + [i] * 2 \
            + [vp]
        lib.scan_flat_fwd.restype = i
        lib.scan_flat_fwd_scratch.argtypes = [ll, ll, ll, ctypes.POINTER(ll)]
        lib.scan_flat_fwd_scratch.restype = None
        lib.scan_flat_error_string.argtypes = [i]
        lib.scan_flat_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def main(argv=None):
    args = parser("K11 against K2 on the same inputs, timed.").parse_args(
        argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for batch in (1, 3):
            a = bench_inputs(rng, batch, args.L, args.dim, KERNEL_N, device)
            ref = mamba_scan_fused(*a)
            got = flat_call(*a)
            err = float((ref.float() - got.float()).abs().max())
            del ref, got
            t_ref = chain_time(lambda *x: mamba_scan_fused(*x), a, k=args.k)
            t_new = chain_time(lambda *x: flat_call(*x), a, k=args.k)
            print(f"batch={batch}: ref {t_ref*1e3:6.2f} ms  flat "
                  f"{t_new*1e3:6.2f} ms  x{t_ref/t_new:4.2f}  err {err:.2e}",
                  flush=True)


if __name__ == "__main__":
    main()
