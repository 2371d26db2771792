"""Direction-aware fused gated selective scan, forward ("dir" variant).

Port of ``segmamba_tpu/ops/scan_pallas_dir.py`` ``mamba_scan_fused_dir``
(:382-444), whose Pallas kernel ``_dir_fwd_kernel`` (:60) runs here as the
hand-written Hopper kernel ``csrc/gated_scan_fwd.cu`` with the flags
``REVERSE``, ``GATE`` and ``HAS_ACC``. ``reverse=True`` scans right to left
in place: inputs and output stay in their original order.

- ``mamba_scan_fused_dir`` takes CPU tensors to the plain version and CUDA
  tensors to the kernel; any other device raises. There is no fallback.
- ``mamba_scan_fused_dir_ref`` is the plain PyTorch version: the chunked
  doubling scan of ``selective_scan.py``, the reverse orientation as
  flip -> scan -> flip, then D-skip, ``acc`` and the ``silu(z)`` gate.
- ``LAUNCHES`` counts this wrapper's kernel launches.

The launcher ``_launch`` is shared with ``scan_fused.py`` (K2 is the same
template with REVERSE=0, GATE=1, HAS_ACC=0).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from segmamba_tpu_torch.ops import _build
from segmamba_tpu_torch.ops.selective_scan import (
    _core_chunked,
    _postprocess,
    _preprocess_delta,
)

LAUNCHES = 0
DEF_CHUNK = 128
_LIB_NAME = "gated_scan_fwd"
_KERNEL_N = 16
_IO_DTYPES = (torch.float32, torch.bfloat16)


def _postprocess_acc(y, u, D, acc, z, out_dtype):
    """y + D u (+ acc) (* silu z), in the kernel's order of operations."""
    if acc is None:
        return _postprocess(y, u, D, z, out_dtype)
    y = _postprocess(y, u, D, None, torch.float32) + acc.float()
    return _postprocess(y, u, None, z, out_dtype)


def mamba_scan_fused_dir_ref(u, dt, z, A, B, C, D, dt_bias, *, acc=None,
                             gate=True, reverse=False, chunk_size=DEF_CHUNK,
                             return_states=False):
    """Plain PyTorch version of ``mamba_scan_fused_dir`` (and, with
    ``gate=True``, of ``scan_fused.mamba_scan_fused``).

    Shapes as ``mamba_scan_fused_dir``. Returns ``out`` (R, L, dim) in
    ``u.dtype``; with ``return_states`` also the chunk exit states
    (R, nc, N, dim) float32, indexed in scan order, chunks cut at multiples
    of ``chunk_size`` of the ORIGINAL layout (the kernel's chunks).
    """
    if gate and z is None:
        raise ValueError("gate=True requires z")
    R, L, _ = u.shape
    delta = _preprocess_delta(dt, dt_bias, True)
    uf, Bf, Cf = u.float(), B.float(), C.float()
    T = min(chunk_size, L)
    if reverse:
        # pad the physical tail first, so the flipped scan's chunks are the
        # kernel's chunks; the identity steps (delta = 0) then come first
        pad = (-L) % T
        padl = lambda t: F.pad(t, (0, 0, 0, pad)).flip(1)
        y, states = _core_chunked(padl(uf), padl(delta), A.float(), padl(Bf),
                                  padl(Cf), chunk_size=T,
                                  return_chunk_states=True)
        y = y.flip(1)[:, :L]
    else:
        y, states = _core_chunked(uf, delta, A.float(), Bf, Cf, chunk_size=T,
                                  return_chunk_states=True)
    y = _postprocess_acc(y, u, D, acc, z if gate else None, u.dtype)
    return (y, states) if return_states else y


def _block_threads(dim):
    """Threads per block (one channel each): the largest of 128/96/64/32
    that divides ``dim``, else a masked block of up to 128."""
    for t in (128, 96, 64, 32):
        if dim % t == 0:
            return t
    return min(128, -(-dim // 32) * 32)


def _row_step_strides(t, name, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must have unit stride, got "
                         f"strides {t.stride()}")
    return [t.stride(0), t.stride(1)]


def _param(t, name, R, shape, device):
    """float32 contiguous parameter; returns (tensor, row stride)."""
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if tuple(t.shape) == tuple(shape):
        return t, 0
    if tuple(t.shape) == (R, *shape):
        return t, t.stride(0)
    raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape} "
                     f"(shared) or {(R, *shape)} (per row)")


def _launch(u, dt, z, acc, A, B, C, D, dt_bias, *, reverse, gate,
            chunk_size, return_states):
    """Launch ``gated_scan_fwd`` on the current stream of u's card."""
    if u.device.type != "cuda":
        raise ValueError(f"the scan kernel runs on CUDA tensors; got "
                         f"{u.device}")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        return _run_kernel(_lib(), stream, u, dt, z, acc, A, B, C, D,
                           dt_bias, reverse=reverse, gate=gate,
                           chunk_size=chunk_size,
                           return_states=return_states)


def _run_kernel(lib, stream, u, dt, z, acc, A, B, C, D, dt_bias, *, reverse,
                gate, chunk_size, return_states):
    """Validate the operands, allocate the output and scratch on u's device
    and call the library's ``gated_scan_fwd`` on ``stream``."""
    if gate and z is None:
        raise ValueError("gate=True requires z")
    if u.dim() != 3:
        raise ValueError(f"u must be (R, L, dim), got {tuple(u.shape)}")
    R, L, dim = u.shape
    N = A.shape[-1]
    if N != _KERNEL_N:
        raise ValueError(f"the scan kernel is built for N={_KERNEL_N}, "
                         f"got N={N}")
    if u.dtype not in _IO_DTYPES:
        raise ValueError(f"unsupported I/O dtype {u.dtype}")
    if not 1 <= chunk_size <= 256:
        raise ValueError(f"chunk_size must be in [1, 256], got {chunk_size}")
    seq = {"u": u, "dt": dt, "B": B, "C": C}
    if gate:
        seq["z"] = z
    if acc is not None:
        seq["acc"] = acc
    for name, t in seq.items():
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}; expected "
                             f"{u.dtype} on {u.device}")
    strides = _row_step_strides(u, "u", (R, L, dim))
    strides += _row_step_strides(dt, "dt", (R, L, dim))
    strides += _row_step_strides(z, "z", (R, L, dim)) if gate else [0, 0]
    strides += (_row_step_strides(acc, "acc", (R, L, dim))
                if acc is not None else [0, 0])
    strides += _row_step_strides(B, "B", (R, L, N))
    strides += _row_step_strides(C, "C", (R, L, N))
    Af, sA = _param(A, "A", R, (dim, N), u.device)
    Df, sD = _param(D, "D", R, (dim,), u.device)
    bf, sb = _param(dt_bias, "dt_bias", R, (dim,), u.device)
    strides += [sA, sD, sb]

    T = min(chunk_size, L)
    nc = -(-L // T)
    out = torch.empty((R, L, dim), dtype=u.dtype, device=u.device)
    states = (torch.empty((R, nc, N, dim), dtype=torch.float32,
                          device=u.device) if return_states else None)
    hbuf = sdelta = None
    if nc > 1:
        hbuf = torch.empty((R, nc, N, dim), dtype=torch.float32,
                           device=u.device)
        sdelta = torch.empty((R, nc, dim), dtype=torch.float32,
                             device=u.device)

    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.gated_scan_fwd(
        ptr(u), ptr(dt), ptr(z) if gate else None, ptr(acc), ptr(B), ptr(C),
        ptr(Af), ptr(Df), ptr(bf), ptr(out), ptr(states), ptr(hbuf),
        ptr(sdelta), int(u.dtype == torch.bfloat16), int(reverse), int(gate),
        int(acc is not None), R, L, dim, N, T, _block_threads(dim),
        (ctypes.c_longlong * 15)(*strides), stream)
    if err != 0:
        msg = lib.gated_scan_error_string(err).decode()
        raise RuntimeError(f"gated_scan_fwd launch failed: {msg} ({err})")
    return (out, states) if return_states else out


_LIB = None


def _lib():
    """The kernel library with its C signatures declared (built on first
    use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load_library(_LIB_NAME)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gated_scan_fwd.argtypes = (
            [vp] * 13 + [i] * 4 + [ll] * 3 + [i] * 3
            + [ctypes.POINTER(ll), vp])
        lib.gated_scan_fwd.restype = i
        lib.gated_scan_error_string.argtypes = [i]
        lib.gated_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def mamba_scan_fused_dir(u, dt, z, A, B, C, D, dt_bias, *, acc=None,
                         gate=True, reverse=False, chunk_size=DEF_CHUNK,
                         return_states=False):
    """Gated scan that runs right to left in place when ``reverse=True``.

    u/dt/z/acc: (R, L, dim) in one storage dtype (float32 or bfloat16);
    B/C: (R, L, N) in that dtype (N = 16 on the kernel); A: (dim, N) shared
    or (R, dim, N) per row; D/dt_bias: (dim,) or (R, dim). With
    ``gate=False`` the raw partial ``y + D u (+ acc)`` is returned (the
    reverse link of the dir2 chain); with ``gate=True`` it is multiplied by
    ``silu(z)``. Returns (R, L, dim) in u.dtype, and with ``return_states``
    the float32 chunk exit states (R, nc, N, dim) in scan order.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if u.device.type == "cpu":
        return mamba_scan_fused_dir_ref(
            u, dt, z, A, B, C, D, dt_bias, acc=acc, gate=gate,
            reverse=reverse, chunk_size=chunk_size,
            return_states=return_states)
    global LAUNCHES
    result = _launch(u, dt, z, acc, A, B, C, D, dt_bias, reverse=reverse,
                     gate=gate, chunk_size=chunk_size,
                     return_states=return_states)
    LAUNCHES += 1
    return result
