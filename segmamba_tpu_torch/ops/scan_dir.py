"""Direction-aware fused gated selective scan ("dir" and "slice" variants),
forward and backward.

Port of ``segmamba_tpu/ops/scan_pallas_dir.py`` ``mamba_scan_fused_dir``
(:382-444) and its custom VJP (``_make_dir_core`` :350-379). The Pallas
kernels ``_dir_fwd_kernel`` (:60) and ``_dir_bwd_kernel`` (:119) run here as
the hand-written Hopper kernels ``csrc/gated_scan_fwd.cu`` and
``csrc/gated_scan_bwd.cu``, each with the flags ``REVERSE``, ``GATE`` and
``HAS_ACC``. ``reverse=True`` scans right to left in place: inputs and
output stay in their original order.

Also the zero-copy slice-order scan K5: ``mamba_scan_fused_slice`` and
``slice_scan_supported`` (JAX :728, :717; custom VJP ``_make_slice_core``
:680; Pallas kernels ``_slice_fwd_kernel`` :477, ``_slice_bwd_kernel``
:514), the templates' ``SLICE`` mode: the gated scan runs in
slice-interleaved order over the original slice-major layout, with no
interleaved copy of any operand. ``mamba_scan_fused_slice_ref`` /
``mamba_scan_fused_slice_bwd_ref`` are its plain versions (interleave,
plain scan, de-interleave; ``autograd.grad`` through that).

- ``mamba_scan_fused_dir`` takes CPU tensors to the plain versions and CUDA
  tensors to the kernels; any other device raises. There is no fallback.
  When grad is enabled and an input requires it, the call goes through
  ``_GatedScan`` (a ``torch.autograd.Function``): its forward asks the
  kernel for the chunk exit states and saves them, its backward launches
  the backward kernel (CUDA) or the plain backward (CPU). Otherwise (no
  grad, ``inference_mode``) nothing is saved and no states are asked for.
- ``mamba_scan_fused_dir_ref`` is the plain PyTorch forward: the chunked
  doubling scan of ``selective_scan.py``, the reverse orientation as
  flip -> scan -> flip, then D-skip, ``acc`` and the ``silu(z)`` gate.
- ``mamba_scan_fused_dir_bwd_ref`` is the plain backward: ``autograd.grad``
  through the plain forward in float32.
- ``LAUNCHES`` / ``BWD_LAUNCHES`` count this entry point's forward and
  backward kernel launches (K1, K3); ``SLICE_LAUNCHES`` /
  ``SLICE_BWD_LAUNCHES`` count the slice-order kernel's (K5).

The templates are built for N = 16 states; the entry points take any N, as
JAX's kernels do. ``_group_fwd`` / ``_group_bwd`` run a call as
ceil(N / 16) launches over groups of 16 states, each launch given as an
argument (so the CPU tests run the same logic with the plain N = 16 scan
in the kernel's place). N < 16 pads B and C with zero state columns and A
with -1: a padded state starts at 0 and stays 0, so the padding is exact,
and its gradients are dropped. N > 16 chains the groups' ungated partials
through ``acc`` (the dir2 link): group g adds its states' ``C . x`` to the
partial of groups 0..g-1, and only the last group adds ``D u`` and applies
the ``silu(z)`` gate. The backward runs the last group first; its ``dacc``
is the gradient of every earlier group's output, and the earlier groups,
ungated and without acc, need no saved partial: only the last group's
``acc`` (the partial of the others) is saved. A bfloat16 chain runs on
float32 copies of its operands (``_wide``), so the partial is never
rounded between groups and the output is rounded once. This beats template
instances per N: the backward of a chain is the existing ``acc`` link,
while an instance per N would multiply the backward's registers and
shared memory by N / 16.

The launchers ``_launch`` / ``_launch_bwd`` and ``_GatedScan`` are shared
with ``scan_fused.py`` (K2/K4 are the same templates with REVERSE=0,
GATE=1, HAS_ACC=0); each call counts on the module of its entry point.
``scan_core.py`` (K6) launches the same templates with ``softplus=False``
(delta final, ungated) and, in the backward, the adjoint seed ``dlast``.
"""

from __future__ import annotations

import ctypes
import sys

import torch
import torch.nn.functional as F

from segmamba_tpu_torch.ops import _build
from segmamba_tpu_torch.ops.selective_scan import (
    _core_chunked,
    _postprocess,
    _preprocess_delta,
)

LAUNCHES = 0
BWD_LAUNCHES = 0
SLICE_LAUNCHES = 0
SLICE_BWD_LAUNCHES = 0
DEF_CHUNK = 128
_LIB_NAME = "gated_scan_fwd"
_BWD_LIB_NAME = "gated_scan_bwd"
_KERNEL_N = 16
_IO_DTYPES = (torch.float32, torch.bfloat16)


def _groups(N):
    """Launches per call: groups of 16 states."""
    return -(-N // _KERNEL_N)


def _pad_states(A, B, C):
    """Pad the state axis to a multiple of 16: A with -1, B and C with zero
    columns."""
    pad = (-A.shape[-1]) % _KERNEL_N
    if not pad:
        return A, B, C
    return (F.pad(A, (0, pad), value=-1.0), F.pad(B, (0, pad)),
            F.pad(C, (0, pad)))


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


def mamba_scan_fused_dir_bwd_ref(u, dt, z, A, B, C, D, dt_bias, dout, *,
                                 acc=None, gate=True, reverse=False,
                                 chunk_size=DEF_CHUNK):
    """Plain PyTorch backward of ``mamba_scan_fused_dir``: ``autograd.grad``
    of the plain forward, run in float32 on float32 copies of the inputs.

    Returns (du, ddt, dz, dacc, dA, dB, dC, dD, dbias), float32, each in its
    input's shape (a shared parameter's gradient summed over rows); dz is
    None without the gate and dacc None without acc.
    """
    inputs = (u, dt, z if gate else None, acc, A, B, C, D, dt_bias)
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().float().requires_grad_()
                  for t in inputs]
        lu, ldt, lz, lacc, lA, lB, lC, lD, lbias = leaves
        out = mamba_scan_fused_dir_ref(lu, ldt, lz, lA, lB, lC, lD, lbias,
                                       acc=lacc, gate=gate, reverse=reverse,
                                       chunk_size=chunk_size)
        grads = iter(torch.autograd.grad(
            out, [t for t in leaves if t is not None], dout.float()))
    return tuple(None if t is None else next(grads) for t in leaves)


def _interleave(t, S):
    """(R, L, X) slice-major -> scan order: new[p S + s] = old[s P + p]."""
    R, L, X = t.shape
    return t.reshape(R, S, L // S, X).transpose(1, 2).reshape(R, L, X)


def _deinterleave(t, S):
    """Inverse of ``_interleave``."""
    R, L, X = t.shape
    return t.reshape(R, L // S, S, X).transpose(1, 2).reshape(R, L, X)


def mamba_scan_fused_slice_ref(u, dt, z, A, B, C, D, dt_bias, *, nslices,
                               chunk_size=DEF_CHUNK, return_states=False,
                               acc=None, gate=True):
    """Plain PyTorch version of ``mamba_scan_fused_slice``: interleave the
    operands, run the plain gated scan, de-interleave the output. With
    ``return_states`` also the chunk exit states (R, nc, N, dim), chunks cut
    at multiples of ``chunk_size`` of the scan (interleaved) order, as the
    kernel cuts them. ``acc`` (original order) and ``gate=False`` are the
    state groups' chain (``_group_fwd``)."""
    il = lambda t: None if t is None else _interleave(t, nslices)
    out, states = mamba_scan_fused_dir_ref(
        il(u), il(dt), il(z) if gate else None, A, il(B), il(C), D, dt_bias,
        acc=il(acc), gate=gate, chunk_size=chunk_size, return_states=True)
    out = _deinterleave(out, nslices)
    return (out, states) if return_states else out


def mamba_scan_fused_slice_bwd_ref(u, dt, z, A, B, C, D, dt_bias, dout, *,
                                   nslices, chunk_size=DEF_CHUNK, acc=None,
                                   gate=True):
    """Plain PyTorch backward of ``mamba_scan_fused_slice``: (du, ddt, dz,
    dacc, dA, dB, dC, dD, dbias), float32, in the inputs' shapes, as
    ``mamba_scan_fused_dir_bwd_ref``; dz is None without the gate and dacc
    None without acc."""
    il = lambda t: None if t is None else _interleave(t, nslices)
    grads = mamba_scan_fused_dir_bwd_ref(
        il(u), il(dt), il(z) if gate else None, A, il(B), il(C), D, dt_bias,
        il(dout), acc=il(acc), gate=gate, chunk_size=chunk_size)
    de = lambda t: None if t is None else _deinterleave(t, nslices)
    du, ddt, dz, dacc, dA, dB, dC, dD, dbias = grads
    return de(du), de(ddt), de(dz), de(dacc), dA, de(dB), de(dC), dD, dbias


def _plain(u, dt, z, acc, A, B, C, D, dt_bias, *, reverse, gate, chunk_size,
           return_states, nslices=0):
    """The plain forward of one scan call (dir or, with ``nslices``,
    slice)."""
    if nslices:
        return mamba_scan_fused_slice_ref(
            u, dt, z, A, B, C, D, dt_bias, nslices=nslices,
            chunk_size=chunk_size, return_states=return_states, acc=acc,
            gate=gate)
    return mamba_scan_fused_dir_ref(
        u, dt, z, A, B, C, D, dt_bias, acc=acc, gate=gate, reverse=reverse,
        chunk_size=chunk_size, return_states=return_states)


def _plain_bwd(u, dt, z, acc, A, B, C, D, dt_bias, dout, *, reverse, gate,
               chunk_size, nslices=0):
    """The plain backward of one scan call (dir or, with ``nslices``,
    slice)."""
    if nslices:
        return mamba_scan_fused_slice_bwd_ref(
            u, dt, z, A, B, C, D, dt_bias, dout, nslices=nslices,
            chunk_size=chunk_size, acc=acc, gate=gate)
    return mamba_scan_fused_dir_bwd_ref(
        u, dt, z, A, B, C, D, dt_bias, dout, acc=acc, gate=gate,
        reverse=reverse, chunk_size=chunk_size)


def _bwd_block_channels(dim):
    """Channels per block of the backward kernel (four threads each): the
    largest of 48/40/32 that divides ``dim``, else a masked block of 48.
    Three blocks of 48 (their checkpoints, staging ring and dB/dC exchange
    in shared memory, 74 KB each at chunk 128) share an SM."""
    for c in (48, 40, 32):
        if dim % c == 0:
            return c
    return 48


def _block_channels(dim):
    """Channels per block of the forward kernel (two threads each): the
    largest of 96/64/32 that divides ``dim``, else a masked block of 64.
    Its shared memory, T x (32 + channels) floats and T x channels of u,
    keeps two blocks of 96 on an SM."""
    for c in (96, 64, 32):
        if dim % c == 0:
            return c
    return 64


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
            chunk_size, return_states, softplus=True, nslices=0):
    """Launch ``gated_scan_fwd`` on the current stream of u's card."""
    _check_cuda(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        return _run_kernel(_lib(), stream, u, dt, z, acc, A, B, C, D,
                           dt_bias, reverse=reverse, gate=gate,
                           chunk_size=chunk_size,
                           return_states=return_states, softplus=softplus,
                           nslices=nslices)


def _launch_bwd(u, dt, z, acc, A, B, C, D, dt_bias, dout, states, *,
                reverse, gate, chunk_size, softplus=True, dlast=None,
                nslices=0):
    """Launch ``gated_scan_bwd`` on the current stream of u's card."""
    _check_cuda(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        return _run_bwd_kernel(_bwd_lib(), stream, u, dt, z, acc, A, B, C, D,
                               dt_bias, dout, states, reverse=reverse,
                               gate=gate, chunk_size=chunk_size,
                               softplus=softplus, dlast=dlast,
                               nslices=nslices)


def _check_cuda(u):
    if u.device.type != "cuda":
        raise ValueError(f"the scan kernel runs on CUDA tensors; got "
                         f"{u.device}")


def _operands(u, dt, z, acc, A, B, C, D, dt_bias, *, gate, chunk_size):
    """Validate the kernels' operands. Returns (R, L, dim, N, T, A, D,
    dt_bias as float32 contiguous parameters, the 15 strides)."""
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
    return R, L, dim, N, min(chunk_size, L), Af, Df, bf, strides


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_kernel(lib, stream, u, dt, z, acc, A, B, C, D, dt_bias, *, reverse,
                gate, chunk_size, return_states, softplus=True, nslices=0):
    """Validate the operands, allocate the output and scratch on u's device
    and call the library's ``gated_scan_fwd`` on ``stream``: one kernel, and
    a zero fill of its flags and ticket before it on the same stream. With
    ``softplus=False`` (K6) dt is the final delta, and the call must be
    float32, forward, ungated and without acc. ``nslices`` > 0 (K5) scans
    in slice-interleaved order; the call must be forward, with ``nslices``
    dividing L (acc, in original order, and an ungated output are the
    state groups' chain). N must be 16 (``_launch_groups`` takes any N)."""
    R, L, dim, N, T, Af, Df, bf, strides = _operands(
        u, dt, z, acc, A, B, C, D, dt_bias, gate=gate, chunk_size=chunk_size)
    nc = -(-L // T)
    out = torch.empty((R, L, dim), dtype=u.dtype, device=u.device)
    states = (torch.empty((R, nc, N, dim), dtype=torch.float32,
                          device=u.device) if return_states else None)
    channels = _block_channels(dim)
    # look-back scratch: aggregate and inclusive records (n_st floats
    # each), sums of delta (n_sd floats) and the flags, the first of them
    # the chunks' ticket (ints, zeroed here)
    sizes = (ctypes.c_longlong * 3)()
    lib.gated_scan_fwd_scratch(R, L, dim, T, sizes)
    n_st, n_sd, n_fl = sizes
    scratch = torch.empty(2 * n_st + n_sd, dtype=torch.float32,
                          device=u.device)
    flags = torch.zeros(n_fl, dtype=torch.int32, device=u.device)
    base = scratch.data_ptr()

    err = lib.gated_scan_fwd(
        _ptr(u), _ptr(dt), _ptr(z) if gate else None, _ptr(acc), _ptr(B),
        _ptr(C), _ptr(Af), _ptr(Df), _ptr(bf), _ptr(out), _ptr(states),
        base, base + 4 * n_st, base + 8 * n_st, _ptr(flags),
        int(u.dtype == torch.bfloat16), int(reverse), int(gate),
        int(acc is not None), int(softplus), int(nslices), R, L, dim, N, T,
        channels, (ctypes.c_longlong * 15)(*strides), stream)
    if err != 0:
        msg = lib.gated_scan_error_string(err).decode()
        raise RuntimeError(f"gated_scan_fwd launch failed: {msg} ({err})")
    return (out, states) if return_states else out


def _run_bwd_kernel(lib, stream, u, dt, z, acc, A, B, C, D, dt_bias, dout,
                    states, *, reverse, gate, chunk_size, softplus=True,
                    dlast=None, nslices=0):
    """Validate the operands, allocate every gradient and one scratch buffer
    (look-back records, per-chunk partials and the flags, zeroed) on u's
    device, call the library's ``gated_scan_bwd`` on ``stream`` (one
    kernel) and reduce the partials. Returns (du, ddt, dz, dacc, dA, dB,
    dC, dD, dbias) in the shapes and dtypes of (u, dt, z, acc, A, B, C, D,
    dt_bias); dz / dacc are None without z / acc. ``dlast`` (R, N, dim)
    float32, or None for zero, is the gradient of the last state in scan
    order; ``softplus=False`` and ``nslices`` as in ``_run_kernel``."""
    R, L, dim, N, T, Af, Df, bf, strides = _operands(
        u, dt, z, acc, A, B, C, D, dt_bias, gate=gate, chunk_size=chunk_size)
    nc = -(-L // T)
    if tuple(states.shape) != (R, nc, N, dim) or (
            states.dtype != torch.float32 or not states.is_contiguous()):
        raise ValueError(f"states: {tuple(states.shape)} {states.dtype}, "
                         f"expected contiguous float32 {(R, nc, N, dim)}")
    dout = dout.to(u.dtype).contiguous()
    if tuple(dout.shape) != (R, L, dim) or dout.device != u.device:
        raise ValueError(f"dout: {tuple(dout.shape)} on {dout.device}, "
                         f"expected {(R, L, dim)} on {u.device}")
    if dlast is not None and (
            tuple(dlast.shape) != (R, N, dim) or dlast.device != u.device
            or dlast.dtype != torch.float32 or not dlast.is_contiguous()):
        raise ValueError(f"dlast: {tuple(dlast.shape)} {dlast.dtype} on "
                         f"{dlast.device}, expected contiguous float32 "
                         f"{(R, N, dim)} on {u.device}")
    channels = _bwd_block_channels(dim)
    seq = dict(dtype=u.dtype, device=u.device)
    du = torch.empty((R, L, dim), **seq)
    ddt = torch.empty((R, L, dim), **seq)
    dz = torch.empty((R, L, dim), **seq) if gate else None
    dacc_k = (torch.empty((R, L, dim), **seq)
              if gate and acc is not None else None)
    # one scratch buffer: aggregate and inclusive records (n_st floats
    # each) and the partials dA (R, nc, dim, N), whose rows the kernel
    # writes as 16-byte vectors; the channel blocks' dB and dC (nbd, R, L,
    # N); sums of delta (n_sd); the partials dD and dbias (R, nc, dim); the
    # flags (n_fl ints, the first the ticket), zeroed here
    sizes = (ctypes.c_longlong * 3)()
    lib.gated_scan_bwd_scratch(R, L, dim, T, channels, sizes)
    n_st, n_sd, n_fl = sizes
    nbd = -(-dim // channels)
    n_dA, n_bc, n_ch = R * nc * dim * N, nbd * R * L * N, R * nc * dim
    o_bc = 2 * n_st + n_dA
    o_sd = o_bc + 2 * n_bc
    scratch = torch.empty(o_sd + n_sd + 2 * n_ch + n_fl,
                          dtype=torch.float32, device=u.device)
    scratch[-n_fl:].zero_()
    dA_p = scratch[2 * n_st:o_bc].view(R, nc, dim, N)
    dB_p, dC_p = scratch[o_bc:o_sd].view(2, nbd, R, L, N)
    dD_p, dbias_p = scratch[o_sd + n_sd:-n_fl].view(2, R, nc, dim)
    at = lambda o: scratch.data_ptr() + 4 * o

    err = lib.gated_scan_bwd(
        _ptr(u), _ptr(dt), _ptr(z) if gate else None, _ptr(acc), _ptr(B),
        _ptr(C), _ptr(dout), _ptr(Af), _ptr(Df), _ptr(bf), _ptr(states),
        _ptr(dlast), _ptr(du), _ptr(ddt), _ptr(dz), _ptr(dacc_k),
        _ptr(dA_p), _ptr(dD_p), _ptr(dbias_p), _ptr(dB_p), _ptr(dC_p),
        at(0), at(n_st), at(o_sd), at(o_sd + n_sd + 2 * n_ch),
        int(u.dtype == torch.bfloat16), int(reverse), int(gate),
        int(acc is not None), int(softplus), int(nslices), R, L, dim, N, T,
        channels, (ctypes.c_longlong * 15)(*strides), stream)
    if err != 0:
        msg = lib.gated_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"gated_scan_bwd launch failed: {msg} ({err})")

    def reduce_param(partial, like):
        """Per-chunk partials (R, nc, ...) -> the parameter's shape: summed
        over chunks, and over rows when the parameter is shared."""
        g = partial.sum(1)
        if like.dim() == partial.dim() - 2:   # shared (row stride 0)
            g = g.sum(0)
        return g.to(like.dtype)

    dacc = dacc_k if dacc_k is not None else (
        dout.to(acc.dtype) if acc is not None else None)
    return (du, ddt, dz, dacc, reduce_param(dA_p, A),
            dB_p.sum(0).to(B.dtype), dC_p.sum(0).to(C.dtype),
            reduce_param(dD_p, D), reduce_param(dbias_p, dt_bias))


_LIB = None


def _lib():
    """The kernel library with its C signatures declared (built on first
    use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load_library(_LIB_NAME)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gated_scan_fwd.argtypes = (
            [vp] * 15 + [i] * 5 + [ll] * 4 + [i] * 3
            + [ctypes.POINTER(ll), vp])
        lib.gated_scan_fwd.restype = i
        lib.gated_scan_fwd_scratch.argtypes = [ll, ll, ll, i,
                                               ctypes.POINTER(ll)]
        lib.gated_scan_fwd_scratch.restype = None
        lib.gated_scan_error_string.argtypes = [i]
        lib.gated_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


_BWD_LIB = None


def _bwd_lib():
    """The backward kernel library with its C signatures declared (built on
    first use)."""
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load_library(_BWD_LIB_NAME)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gated_scan_bwd.argtypes = (
            [vp] * 25 + [i] * 5 + [ll] * 4 + [i] * 3
            + [ctypes.POINTER(ll), vp])
        lib.gated_scan_bwd.restype = i
        lib.gated_scan_bwd_scratch.argtypes = [ll, ll, ll, i, i,
                                               ctypes.POINTER(ll)]
        lib.gated_scan_bwd_scratch.restype = None
        lib.gated_scan_bwd_error_string.argtypes = [i]
        lib.gated_scan_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def _group_fwd(acc, A, B, C, D, *, gate, launch):
    """A scan call over any N as ceil(N / 16) launches of 16 states:
    ``launch(acc_g, A_g, B_g, C_g, D_g, gate_g)`` -> (out_g, chunk exit
    states_g or None). Group g takes the previous group's output as its
    acc (the caller's ``acc`` for g = 0); the last group takes D and the
    gate, the others D = 0 and no gate. Returns (out, states (R, nc, N,
    dim) or None, the acc the last group took)."""
    N = A.shape[-1]
    A, B, C = _pad_states(A, B, C)
    G = _groups(N)
    states, part, last_acc = [], acc, acc
    for g in range(G):
        sl = slice(g * _KERNEL_N, (g + 1) * _KERNEL_N)
        last = g == G - 1
        last_acc = part
        part, st = launch(part, A[..., sl], B[..., sl], C[..., sl],
                          D if last else torch.zeros_like(D), gate and last)
        states.append(st)
    if states[0] is not None:
        states = (states[0] if G == 1 else torch.cat(states, 2))[:, :, :N]
    else:
        states = None
    return part, states, last_acc


def _group_bwd(acc, A, B, C, D, dout, states, last_acc, *, gate,
               launch_bwd):
    """The backward of ``_group_fwd``: ``launch_bwd(acc_g, A_g, B_g, C_g,
    D_g, gate_g, dout_g, states_g)`` -> (du, ddt, dz, dacc, dA, dB, dC, dD,
    dbias) of one group. The last group runs first with ``last_acc`` and
    ``dout``; its dacc is the dout of every earlier group (ungated links),
    which runs without acc. Returns the nine gradients of the call: du,
    ddt and dbias summed over the groups (du, ddt in float32 before the
    cast back), dA, dB, dC concatenated and cropped to N, dz and dD from
    the last group, dacc the chain's (None without ``acc``)."""
    N = A.shape[-1]
    A, B, C = _pad_states(A, B, C)
    if A.shape[-1] != N:   # the padded states' exit states are 0
        states = F.pad(states, (0, 0, 0, A.shape[-1] - N))
    G = _groups(N)
    at = lambda t, g: t[..., g * _KERNEL_N:(g + 1) * _KERNEL_N]
    st = lambda g: states[:, :, g * _KERNEL_N:(g + 1) * _KERNEL_N]
    du, ddt, dz, dpart, dA, dB, dC, dD, dbias = launch_bwd(
        last_acc, at(A, G - 1), at(B, G - 1), at(C, G - 1), D, gate, dout,
        st(G - 1).contiguous())
    if N == _KERNEL_N:
        return du, ddt, dz, dpart, dA, dB, dC, dD, dbias
    dt_dtype = ddt.dtype
    du, ddt, dAs, dBs, dCs = du.float(), ddt.float(), [dA], [dB], [dC]
    for g in range(G - 2, -1, -1):
        du_g, ddt_g, _, _, dA_g, dB_g, dC_g, _, dbias_g = launch_bwd(
            None, at(A, g), at(B, g), at(C, g), torch.zeros_like(D), False,
            dpart, st(g).contiguous())
        du, ddt, dbias = du + du_g.float(), ddt + ddt_g.float(), \
            dbias + dbias_g
        dAs.insert(0, dA_g)
        dBs.insert(0, dB_g)
        dCs.insert(0, dC_g)
    cat = lambda ts: torch.cat(ts, -1)[..., :N]
    return (du.to(dt_dtype), ddt.to(dt_dtype), dz,
            dpart if acc is not None else None, cat(dAs), cat(dBs),
            cat(dCs), dD, dbias)


def _wide(N, *ts):
    """bfloat16 operands of a chain of groups (N > 16) as float32 copies:
    the partial handed from group to group then stays float32, and the
    output is rounded once, as the plain version rounds it."""
    if _groups(N) == 1 or ts[0].dtype != torch.bfloat16:
        return ts
    return tuple(None if t is None else t.float() for t in ts)


def _launch_groups(u, dt, z, acc, A, B, C, D, dt_bias, *, reverse, gate,
                   chunk_size, return_states, nslices=0):
    """The forward kernel over any N (``_group_fwd``): (out, states or
    None, the last group's acc)."""
    out_dtype = u.dtype
    u, dt, z, acc, B, C = _wide(A.shape[-1], u, dt, z, acc, B, C)

    def launch(acc_g, A_g, B_g, C_g, D_g, gate_g):
        res = _launch(u, dt, z if gate_g else None, acc_g, A_g, B_g, C_g,
                      D_g, dt_bias, reverse=reverse, gate=gate_g,
                      chunk_size=chunk_size, return_states=return_states,
                      nslices=nslices)
        return res if return_states else (res, None)

    out, states, last_acc = _group_fwd(acc, A, B, C, D, gate=gate,
                                       launch=launch)
    return out.to(out_dtype), states, last_acc


def _launch_groups_bwd(u, dt, z, acc, A, B, C, D, dt_bias, dout, states,
                       last_acc, *, reverse, gate, chunk_size, nslices=0):
    """The backward kernel over any N (``_group_bwd``); gradients in the
    kernel's dtype (float32 for a bfloat16 chain), cast by the caller."""
    u, dt, z, acc, B, C, dout = _wide(A.shape[-1], u, dt, z, acc, B, C,
                                      dout)

    def launch_bwd(acc_g, A_g, B_g, C_g, D_g, gate_g, dout_g, states_g):
        return _launch_bwd(u, dt, z if gate_g else None, acc_g, A_g, B_g,
                           C_g, D_g, dt_bias, dout_g, states_g,
                           reverse=reverse, gate=gate_g,
                           chunk_size=chunk_size, nslices=nslices)

    return _group_bwd(acc, A, B, C, D, dout, states, last_acc, gate=gate,
                      launch_bwd=launch_bwd)


def _count(owner, name, nslices, n=1):
    """``n`` launches on ``owner``'s counter ``name``, or on
    ``SLICE_<name>`` for the slice-order kernel (K5)."""
    name = f"SLICE_{name}" if nslices else name
    setattr(owner, name, getattr(owner, name) + n)


class _GatedScan(torch.autograd.Function):
    """The gated scan with its backward (the custom VJP of the JAX
    package's ``_make_dir_core`` / ``_make_core`` / ``_make_slice_core``).

    ``owner`` is the module of the entry point (``scan_dir`` or
    ``scan_fused``), whose ``LAUNCHES`` / ``BWD_LAUNCHES`` count the kernel
    launches. ``flags`` are (reverse, gate, chunk_size, nslices); nslices
    > 0 is the slice-order scan. CUDA tensors run the kernels, CPU tensors
    the plain versions; the wiring (which inputs get gradients,
    shared-parameter sums, dtype casts, the ``acc`` link) is the same for
    both.
    """

    @staticmethod
    def forward(ctx, owner, flags, u, dt, z, acc, A, B, C, D, dt_bias):
        reverse, gate, chunk_size, nslices = flags
        kw = dict(reverse=reverse, gate=gate, chunk_size=chunk_size,
                  return_states=True, nslices=nslices)
        if u.device.type == "cpu":
            out, states = _plain(u, dt, z, acc, A, B, C, D, dt_bias, **kw)
            last_acc = None
        else:
            out, states, last_acc = _launch_groups(
                u, dt, z, acc, A, B, C, D, dt_bias, **kw)
            _count(owner, "LAUNCHES", nslices, _groups(A.shape[-1]))
        ctx.owner, ctx.flags = owner, flags
        ctx.save_for_backward(u, dt, z, acc, A, B, C, D, dt_bias, states,
                              last_acc)
        ctx.mark_non_differentiable(states)
        return out, states

    @staticmethod
    def backward(ctx, dout, _dstates):
        reverse, gate, chunk_size, nslices = ctx.flags
        kw = dict(reverse=reverse, gate=gate, chunk_size=chunk_size,
                  nslices=nslices)
        u, dt, z, acc, A, B, C, D, dt_bias, states, last_acc = (
            ctx.saved_tensors)
        if u.device.type == "cpu":
            grads = _plain_bwd(u, dt, z, acc, A, B, C, D, dt_bias, dout, **kw)
        else:
            grads = _launch_groups_bwd(u, dt, z, acc, A, B, C, D, dt_bias,
                                       dout, states, last_acc, **kw)
            _count(ctx.owner, "BWD_LAUNCHES", nslices, _groups(A.shape[-1]))
        inputs = (u, dt, z, acc, A, B, C, D, dt_bias)
        return (None, None) + tuple(
            None if g is None or not need else g.to(t.dtype)
            for g, t, need in zip(grads, inputs, ctx.needs_input_grad[2:]))


def _scan(owner, u, dt, z, acc, A, B, C, D, dt_bias, *, reverse, gate,
          chunk_size, return_states, nslices=0):
    """Route one scan call: through ``_GatedScan`` when a gradient is to be
    recorded, else straight to the kernel (CUDA) or the plain forward
    (CPU)."""
    if gate and z is None:
        raise ValueError("gate=True requires z")
    if not gate:
        z = None
    inputs = (u, dt, z, acc, A, B, C, D, dt_bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        out, states = _GatedScan.apply(
            owner, (reverse, gate, chunk_size, nslices), *inputs)
        return (out, states) if return_states else out
    kw = dict(reverse=reverse, gate=gate, chunk_size=chunk_size,
              return_states=return_states, nslices=nslices)
    if u.device.type == "cpu":
        return _plain(u, dt, z, acc, A, B, C, D, dt_bias, **kw)
    out, states, _ = _launch_groups(u, dt, z, acc, A, B, C, D, dt_bias, **kw)
    _count(owner, "LAUNCHES", nslices, _groups(A.shape[-1]))
    return (out, states) if return_states else out


def mamba_scan_fused_dir(u, dt, z, A, B, C, D, dt_bias, *, acc=None,
                         gate=True, reverse=False, chunk_size=DEF_CHUNK,
                         return_states=False):
    """Gated scan that runs right to left in place when ``reverse=True``.

    u/dt/z/acc: (R, L, dim) in one storage dtype (float32 or bfloat16);
    B/C: (R, L, N) in that dtype (any N; the kernel runs ceil(N / 16)
    launches of 16 states, ``_group_fwd``); A: (dim, N) shared
    or (R, dim, N) per row; D/dt_bias: (dim,) or (R, dim). With
    ``gate=False`` the raw partial ``y + D u (+ acc)`` is returned (the
    reverse link of the dir2 chain); with ``gate=True`` it is multiplied by
    ``silu(z)``. Returns (R, L, dim) in u.dtype, and with ``return_states``
    the float32 chunk exit states (R, nc, N, dim) in scan order.

    CPU tensors run the plain versions; CUDA tensors launch the kernels.
    Differentiable in every tensor argument.
    """
    return _scan(sys.modules[__name__], u, dt, z, acc, A, B, C, D, dt_bias,
                 reverse=reverse, gate=gate, chunk_size=chunk_size,
                 return_states=return_states)


def slice_scan_supported(seqlen, nslices, chunk_size=DEF_CHUNK):
    """Whether ``mamba_scan_fused_slice`` takes this (L, S): any S >= 2 that
    divides L. The card's kernel cuts the scan order into chunks of
    ``chunk_size`` steps with a ragged last chunk, so it needs none of the
    JAX kernel's block rules (its (S, Tp) blocks with Tp | P, Tp >= 8 and
    S Tp a multiple of 128, ``scan_pallas_dir.py:706-725``); the model's
    output is the same either way, since the slice kernel and the
    interleave path compute the same numbers. ``chunk_size`` is accepted
    for the JAX signature."""
    del chunk_size
    return nslices is not None and nslices >= 2 and seqlen % nslices == 0


def mamba_scan_fused_slice(u, dt, z, A, B, C, D, dt_bias, *, nslices,
                           chunk_size=DEF_CHUNK, return_states=False):
    """Gated scan in slice-INTERLEAVED order over original-layout data.

    u/dt/z: (R, L, dim), B/C: (R, L, N), all in the original (slice-major)
    token order, one storage dtype (float32 or bfloat16); A: (dim, N) or
    (R, dim, N), D/dt_bias: (dim,) or (R, dim). The scan runs as if the
    sequence had been interleaved (``new[p S + s] = old[s P + p]``, S =
    ``nslices``, P = L / S) and the gated output comes back in original
    order, (R, L, dim) in u.dtype; with ``return_states`` also the float32
    chunk exit states (R, nc, N, dim) in scan order. Requires
    ``slice_scan_supported(L, nslices)``.

    CPU tensors run the plain versions; CUDA tensors launch the kernel (no
    operand is reordered in device memory). Differentiable in every tensor
    argument.
    """
    if not slice_scan_supported(u.shape[1], nslices):
        raise ValueError(f"nslices={nslices} must be >= 2 and divide "
                         f"L={u.shape[1]}")
    return _scan(sys.modules[__name__], u, dt, z, None, A, B, C, D, dt_bias,
                 reverse=False, gate=True, chunk_size=chunk_size,
                 return_states=return_states, nslices=nslices)
