"""Projection-fused direction-aware gated scan (K8), forward and backward.

Port of ``segmamba_tpu/ops/scan_pallas_proj.py`` ``mamba_scan_proj``
(:406-466), ``proj_scan_supported`` (:401) and its custom VJP
(``_make_proj_core`` :369). The Pallas kernels ``_proj_fwd_kernel`` (:71)
and ``_proj_bwd_kernel`` (:134) run here as the ``PROJ`` instances of the
single-pass scan templates, ``proj_fwd_kernel`` in ``csrc/gated_scan_fwd.cu``
and ``proj_bwd_kernel`` in ``csrc/gated_scan_bwd.cu`` (entries
``proj_scan_fwd`` / ``proj_scan_bwd`` in those two libraries): one kernel a
call each way, a block owning all channels of one chunk, the chunk carries
by decoupled look-back. Per direction the kernel itself computes the
projections from the conv output ``xc``::

    x_dbl = xc @ x_proj       (in the kernel, float32 sums; on the tensor
                               cores when xc and x_proj are both bfloat16)
    delta = softplus(x_dbl[:, :R] @ dt_proj + dt_bias)
    out   = (scan(xc, delta, A, B, C) + D xc [+ acc]) [* silu(z)]

so delta, B and C never go to device memory, and the backward has no
(blocks, R, L, N) dB/dC buffers. ``acc`` and ``z`` chain the orientations
(slice and reverse emit ungated partials, forward adds them and gates once).
The port does not pad ``dt_rank`` to 8 as JAX does (a TPU layout rule; the
padding is exact); the kernels take dt_rank <= ``MAX_RANK``, and a chunk's
tile must fit one block's shared memory (``proj_scan_supported``: at the
default chunk of 128, dt_rank <= 6 at d_inner = 128; at 256, d_inner <=
64). The model sends other layers to the directional scan.

- ``mamba_scan_proj`` takes CPU tensors to the plain versions and CUDA
  tensors to the kernels; any other device raises. There is no fallback.
  With grad enabled and an input that requires it, it goes through
  ``_ProjScan`` (a ``torch.autograd.Function``).
- ``mamba_scan_proj_ref`` is the plain forward: float32 einsum projections,
  then ``scan_dir.mamba_scan_fused_dir_ref`` (the plain directional scan
  with ``acc`` and the gate); ``mamba_scan_proj_bwd_ref`` the plain
  backward, ``autograd.grad`` through it in float32.
- ``LAUNCHES`` / ``BWD_LAUNCHES`` count this wrapper's kernel launches.

The kernels are built for N = 16 states; ``mamba_scan_proj`` takes any N
as ceil(N / 16) launches (``scan_dir._group_fwd`` / ``_group_bwd`` here,
each launch given as an argument): group g projects with x_proj's dt
columns and its own 16 B and 16 C columns (N < 16: zero columns, A
padded with -1, exact), takes the previous group's ungated output as
``acc``, and only the last group adds ``D xc`` and applies the gate, as
``scan_dir``'s chain does (a bfloat16 chain on float32 copies of its
operands).
"""

from __future__ import annotations

import ctypes

import torch

from segmamba_tpu_torch.ops import scan_dir
from segmamba_tpu_torch.ops.scan_dir import (
    _IO_DTYPES,
    _check_cuda,
    _group_fwd,
    _groups,
    _ptr,
    _wide,
    mamba_scan_fused_dir_ref,
)

LAUNCHES = 0
BWD_LAUNCHES = 0
DEF_CHUNK = 128
MAX_CHANNELS = 128
MAX_RANK = 16
SMEM_LIMIT = 232448   # bytes of shared memory an H100 block may take
_KERNEL_N = 16


def _smem_bytes(E, rank, T, itemsize):
    """Shared memory of the forward and the backward kernel's block in
    bytes, for E channels, dt_rank ``rank``, chunk T and I/O elements of
    ``itemsize`` bytes: the libraries' ``proj_scan_fwd_smem`` /
    ``proj_scan_bwd_smem``, mirrored so that the dispatch needs no
    library."""
    N, K, NA = _KERNEL_N, 8, 5   # states, backward group, slot arrays
    up = lambda x, m: -(-x // m) * m
    # forward: B, C, delta, the xc rows (DB + 4 a row), xdt, the weights
    DB = up(E, 32)
    fwd = 4 * (4 + T * (2 * N + DB) + up(T * (DB + 4) * itemsize, 16) // 4
               + up(T * rank, 4) + (2 * rank + 2 * N) * DB)
    # backward: the checkpoints' region (or the chunk's xc rows, if
    # larger), two slots, the exchange, the tile's B, C and xdt, the
    # weights, a group's sums and its per (step, channel) terms
    DB, nch, ng = max(32, up(E, 8)), up(E, 16), -(-T // K)
    ncol = rank + 2 * N
    ck = max((ng - 1) * DB * N, up(ng * K * (nch + 4) * itemsize, 16) // 4)
    bwd = 16 + 4 * (ck + 2 * K * NA * DB + DB // 8 * K * 32
                    + 2 * ng * K * N + up(ng * K * rank, 4)
                    + (ncol + rank) * nch + up(K * ncol, 4) + 2 * K * DB)
    return fwd, bwd


def proj_scan_supported(d_inner, dt_rank=1, chunk_size=DEF_CHUNK,
                        dtype=torch.float32):
    """Whether the kernels take a layer: its d_inner <= 128 channels in one
    block (the projections mix them all), 1 <= dt_rank <= 16, and the
    chunk's tile in the block's shared memory, forward and backward, at
    I/O ``dtype`` (float32 takes the most). At the default chunk of 128
    that is dt_rank <= 6 at d_inner = 128; at a chunk of 256, d_inner <=
    64. The model asks at float32, so a layer's composition does not
    depend on its dtype."""
    if not (1 <= d_inner <= MAX_CHANNELS and 1 <= dt_rank <= MAX_RANK):
        return False
    return max(_smem_bytes(d_inner, dt_rank, chunk_size,
                           dtype.itemsize)) <= SMEM_LIMIT


def _unsupported(E, rank, T):
    return ValueError(
        f"d_inner={E}, dt_rank={rank}, chunk {T}: the projection-fused "
        f"kernel takes d_inner <= {MAX_CHANNELS}, 1 <= dt_rank <= "
        f"{MAX_RANK} and a chunk whose tile fits {SMEM_LIMIT} bytes of "
        "shared memory (proj_scan_supported); use "
        "scan_dir.mamba_scan_fused_dir")


def mamba_scan_proj_ref(xc, x_proj, dt_proj, dt_bias, A, D_skip, *, z=None,
                        acc=None, reverse=False, chunk_size=DEF_CHUNK,
                        return_states=False):
    """Plain PyTorch version of ``mamba_scan_proj``: the projections as
    float32 matrix products, then the plain directional scan. With
    ``return_states`` also the float32 chunk exit states (b, nc, N, E) in
    scan order, as the kernel saves them."""
    N = A.shape[-1]
    rank = x_proj.shape[1] - 2 * N
    x_dbl = xc.float() @ x_proj.float()
    dt = x_dbl[..., :rank] @ dt_proj.float()
    B, C = x_dbl[..., rank:rank + N], x_dbl[..., rank + N:]
    return mamba_scan_fused_dir_ref(
        xc, dt, z, A, B, C, D_skip, dt_bias, acc=acc, gate=z is not None,
        reverse=reverse, chunk_size=chunk_size, return_states=return_states)


def mamba_scan_proj_bwd_ref(xc, x_proj, dt_proj, dt_bias, A, D_skip, dout,
                            *, z=None, acc=None, reverse=False,
                            chunk_size=DEF_CHUNK):
    """Plain backward of ``mamba_scan_proj``: ``autograd.grad`` of the plain
    forward, in float32 on float32 copies of the inputs. Returns (dxc,
    dx_proj, ddt_proj, ddt_bias, dA, dD, dz, dacc), float32, in the inputs'
    shapes; dz / dacc are None without z / acc."""
    inputs = (xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc)
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().float().requires_grad_()
                  for t in inputs]
        lxc, lw, ldtp, lb, lA, lD, lz, lacc = leaves
        out = mamba_scan_proj_ref(lxc, lw, ldtp, lb, lA, lD, z=lz, acc=lacc,
                                  reverse=reverse, chunk_size=chunk_size)
        grads = iter(torch.autograd.grad(
            out, [t for t in leaves if t is not None], dout.float()))
    return tuple(None if t is None else next(grads) for t in leaves)


def _seq_strides(t, name, shape, like):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}; expected "
                         f"{like.dtype} on {like.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must have unit stride, got "
                         f"strides {t.stride()}")
    return [t.stride(0), t.stride(1)]


def _f32(t, name, shape, device):
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    return t


def _operands(xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, chunk_size):
    """Validate the kernels' operands. Returns (b, L, E, rank, T, the float32
    contiguous W, dt_proj, bias, A, D, the six strides)."""
    if xc.dim() != 3:
        raise ValueError(f"xc must be (batch, L, d_inner), got "
                         f"{tuple(xc.shape)}")
    b, L, E = xc.shape
    N = A.shape[-1]
    if N != _KERNEL_N:
        raise ValueError(f"the projection-fused kernel is built for "
                         f"N={_KERNEL_N}, got N={N}")
    if xc.dtype not in _IO_DTYPES:
        raise ValueError(f"unsupported I/O dtype {xc.dtype}")
    if not 1 <= chunk_size <= 256:
        raise ValueError(f"chunk_size must be in [1, 256], got {chunk_size}")
    rank = x_proj.shape[1] - 2 * N
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"x_proj {tuple(x_proj.shape)}: needs dt_rank + "
                         f"2 * {N} columns, 1 <= dt_rank <= {MAX_RANK}")
    if not proj_scan_supported(E, rank, min(chunk_size, L), xc.dtype):
        raise _unsupported(E, rank, min(chunk_size, L))
    dev = xc.device
    W = _f32(x_proj, "x_proj", (E, rank + 2 * N), dev)
    dtp = _f32(dt_proj, "dt_proj", (rank, E), dev)
    bias = _f32(dt_bias, "dt_bias", (E,), dev)
    Af = _f32(A, "A", (E, N), dev)
    Df = _f32(D_skip, "D_skip", (E,), dev)
    strides = _seq_strides(xc, "xc", (b, L, E), xc)
    strides += (_seq_strides(z, "z", (b, L, E), xc) if z is not None
                else [0, 0])
    strides += (_seq_strides(acc, "acc", (b, L, E), xc) if acc is not None
                else [0, 0])
    return b, L, E, rank, min(chunk_size, L), W, dtp, bias, Af, Df, strides


def _tensor_cores(xc, x_proj):
    """Whether the kernels may form x_dbl = xc x_proj on the tensor cores
    (bf16 x bf16 -> f32, every product exact): both in bfloat16."""
    return int(xc.dtype == x_proj.dtype == torch.bfloat16)


def _run_kernel(lib, stream, xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc,
                *, reverse, chunk_size, return_states):
    """Validate the operands, allocate the output and the look-back scratch
    on xc's device and call the library's ``proj_scan_fwd`` on ``stream``:
    one kernel, and a zero fill of its flags and ticket before it."""
    b, L, E, rank, T, W, dtp, bias, Af, Df, strides = _operands(
        xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, chunk_size)
    N = _KERNEL_N
    nc = -(-L // T)
    f32 = dict(dtype=torch.float32, device=xc.device)
    out = torch.empty((b, L, E), dtype=xc.dtype, device=xc.device)
    states = torch.empty((b, nc, N, E), **f32) if return_states else None
    # aggregate and inclusive records (n_st floats each), sums of delta
    # (n_sd) and the flags, the first of them the ticket (ints, zeroed)
    sizes = (ctypes.c_longlong * 3)()
    lib.gated_scan_fwd_scratch(b, L, E, T, sizes)
    n_st, n_sd, n_fl = sizes
    scratch = torch.empty(2 * n_st + n_sd, **f32)
    flags = torch.zeros(n_fl, dtype=torch.int32, device=xc.device)
    at = lambda o: scratch.data_ptr() + 4 * o
    err = lib.proj_scan_fwd(
        _ptr(xc), _ptr(z), _ptr(acc), _ptr(W), _ptr(dtp), _ptr(bias),
        _ptr(Af), _ptr(Df), _ptr(out), _ptr(states), at(0), at(n_st),
        at(2 * n_st), _ptr(flags), int(xc.dtype == torch.bfloat16),
        _tensor_cores(xc, x_proj), int(reverse), int(z is not None),
        int(acc is not None), b, L, E, rank, T,
        (ctypes.c_longlong * 6)(*strides), stream)
    if err != 0:
        msg = lib.gated_scan_error_string(err).decode()
        raise RuntimeError(f"proj_scan_fwd launch failed: {msg} ({err})")
    return (out, states) if return_states else out


def _run_bwd_kernel(lib, stream, xc, x_proj, dt_proj, dt_bias, A, D_skip, z,
                    acc, dout, states, *, reverse, chunk_size):
    """Validate the operands, allocate every gradient, partial and scratch
    buffer on xc's device, call the library's ``proj_scan_bwd`` on
    ``stream`` and sum the per-block partials. Returns (dxc, dx_proj,
    ddt_proj, ddt_bias, dA, dD, dz, dacc) in the shapes and dtypes of the
    inputs; dz / dacc are None without z / acc."""
    b, L, E, rank, T, W, dtp, bias, Af, Df, strides = _operands(
        xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, chunk_size)
    N = _KERNEL_N
    nc = -(-L // T)
    if tuple(states.shape) != (b, nc, N, E) or (
            states.dtype != torch.float32 or not states.is_contiguous()):
        raise ValueError(f"states: {tuple(states.shape)} {states.dtype}, "
                         f"expected contiguous float32 {(b, nc, N, E)}")
    dout = dout.to(xc.dtype).contiguous()
    if tuple(dout.shape) != (b, L, E) or dout.device != xc.device:
        raise ValueError(f"dout: {tuple(dout.shape)} on {dout.device}, "
                         f"expected {(b, L, E)} on {xc.device}")
    gate, has_acc = z is not None, acc is not None
    seq = dict(dtype=xc.dtype, device=xc.device)
    dxc = torch.empty((b, L, E), **seq)
    dz = torch.empty((b, L, E), **seq) if gate else None
    dacc_k = torch.empty((b, L, E), **seq) if gate and has_acc else None
    # one scratch buffer: aggregate and inclusive records (n_st floats
    # each, float4 rows first), sums of delta (n_sd), the per-(row, chunk)
    # weight-gradient partials (pw floats each), the flags (n_fl ints, the
    # first the ticket), zeroed here
    sizes = (ctypes.c_longlong * 3)()
    lib.gated_scan_bwd_scratch(b, L, E, T, lib.proj_scan_bwd_channels(E),
                               sizes)
    n_st, n_sd, n_fl = sizes
    pw = (2 * rank + 3 * N + 2) * E
    o_part = 2 * n_st + n_sd
    scratch = torch.empty(o_part + b * nc * pw + n_fl, dtype=torch.float32,
                          device=xc.device)
    scratch[-n_fl:].zero_()
    part = scratch[o_part:o_part + b * nc * pw].view(b, nc, pw)
    at = lambda o: scratch.data_ptr() + 4 * o
    err = lib.proj_scan_bwd(
        _ptr(xc), _ptr(z), _ptr(acc), _ptr(dout), _ptr(W), _ptr(dtp),
        _ptr(bias), _ptr(Af), _ptr(Df), _ptr(states), _ptr(dxc), _ptr(dz),
        _ptr(dacc_k), _ptr(part), at(0), at(n_st), at(2 * n_st),
        at(o_part + b * nc * pw), int(xc.dtype == torch.bfloat16),
        _tensor_cores(xc, x_proj), int(reverse), int(gate), int(has_acc), b,
        L, E, rank, T, (ctypes.c_longlong * 6)(*strides), stream)
    if err != 0:
        msg = lib.gated_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"proj_scan_bwd launch failed: {msg} ({err})")
    tot = part.sum((0, 1))
    ncol = rank + 2 * N
    sizes = (ncol * E, rank * E, N * E, E, E)
    dWt, ddtp, dAt, dbias, dD = torch.split(tot, sizes)
    dacc = dacc_k if dacc_k is not None else (
        dout.to(acc.dtype) if has_acc else None)
    return (dxc, dWt.view(ncol, E).t().to(x_proj.dtype),
            ddtp.view(rank, E).to(dt_proj.dtype), dbias.to(dt_bias.dtype),
            dAt.view(N, E).t().to(A.dtype), dD.to(D_skip.dtype), dz, dacc)


_DECLARED = set()


def _lib():
    """The forward template's library (``gated_scan_fwd``, built on first
    use) with K8's entry declared."""
    lib = scan_dir._lib()
    if "fwd" not in _DECLARED:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.proj_scan_fwd.argtypes = ([vp] * 14 + [i] * 5 + [ll] * 3
                                      + [i] * 2 + [ctypes.POINTER(ll), vp])
        lib.proj_scan_fwd.restype = i
        lib.proj_scan_fwd_smem.argtypes = [ll, i, i, i]
        lib.proj_scan_fwd_smem.restype = ll
        _DECLARED.add("fwd")
    return lib


def _bwd_lib():
    """The backward template's library (``gated_scan_bwd``, built on first
    use) with K8's entries declared."""
    lib = scan_dir._bwd_lib()
    if "bwd" not in _DECLARED:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.proj_scan_bwd.argtypes = ([vp] * 18 + [i] * 5 + [ll] * 3
                                      + [i] * 2 + [ctypes.POINTER(ll), vp])
        lib.proj_scan_bwd.restype = i
        lib.proj_scan_bwd_channels.argtypes = [i]
        lib.proj_scan_bwd_channels.restype = i
        lib.proj_scan_bwd_smem.argtypes = [ll, i, i, i]
        lib.proj_scan_bwd_smem.restype = ll
        _DECLARED.add("bwd")
    return lib


def _launch(xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, *, reverse,
            chunk_size, return_states):
    """Launch ``proj_scan_fwd`` on the current stream of xc's card."""
    _check_cuda(xc)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        return _run_kernel(_lib(), stream, xc, x_proj, dt_proj, dt_bias, A,
                           D_skip, z, acc, reverse=reverse,
                           chunk_size=chunk_size,
                           return_states=return_states)


def _launch_bwd(xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, dout,
                states, *, reverse, chunk_size):
    """Launch ``proj_scan_bwd`` on the current stream of xc's card."""
    _check_cuda(xc)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        return _run_bwd_kernel(_bwd_lib(), stream, xc, x_proj, dt_proj,
                               dt_bias, A, D_skip, z, acc, dout, states,
                               reverse=reverse, chunk_size=chunk_size)


def _split_proj(x_proj, N):
    """x_proj (E, rank + 2N) -> its dt, B and C columns."""
    rank = x_proj.shape[1] - 2 * N
    return x_proj[:, :rank], x_proj[:, rank:rank + N], x_proj[:, rank + N:]


def _launch_groups(xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, *,
                   reverse, chunk_size, return_states):
    """The forward kernel over any N: ``scan_dir._group_fwd`` over x_proj's
    B and C columns, each group projecting with the dt columns and its own
    16 B and C columns; a bfloat16 chain on float32 copies
    (``scan_dir._wide``). Returns (out, states or None, the last group's
    acc)."""
    out_dtype = xc.dtype
    xc, z, acc = _wide(A.shape[-1], xc, z, acc)
    Wdt, WB, WC = _split_proj(x_proj, A.shape[-1])

    def launch(acc_g, A_g, WB_g, WC_g, D_g, gate_g):
        res = _launch(xc, torch.cat([Wdt, WB_g, WC_g], 1), dt_proj, dt_bias,
                      A_g, D_g, z if gate_g else None, acc_g,
                      reverse=reverse, chunk_size=chunk_size,
                      return_states=return_states)
        return res if return_states else (res, None)

    out, states, last_acc = _group_fwd(acc, A, WB, WC, D_skip,
                                       gate=z is not None, launch=launch)
    return out.to(out_dtype), states, last_acc


def _group_bwd(x_proj, A, D_skip, z, acc, dout, states, last_acc, *,
               launch_bwd):
    """The backward of a K8 call over groups of 16 states:
    ``scan_dir._group_bwd`` over x_proj's B and C columns, with
    ``launch_bwd(x_proj_g, A_g, D_g, z_g, acc_g, dout_g, states_g)`` ->
    (dxc, dx_proj_g, ddt_proj, ddt_bias, dA_g, dD, dz, dacc) of one group
    given in its slots: dxc as du, x_proj's dt columns as ddt (float32),
    ddt_proj and ddt_bias packed in float32 as dbias, so that all four are
    summed over the groups. Returns the call's eight gradients."""
    Wdt, WB, WC = _split_proj(x_proj, A.shape[-1])
    rank, E = Wdt.shape[1], x_proj.shape[0]

    def launch(acc_g, A_g, WB_g, WC_g, D_g, gate_g, dout_g, states_g):
        dxc, dW, ddtp, dbias, dA, dD, dz, dacc = launch_bwd(
            torch.cat([Wdt, WB_g, WC_g], 1), A_g, D_g, z if gate_g else None,
            acc_g, dout_g, states_g)
        packed = torch.cat([ddtp.float().flatten(), dbias.float()])
        return (dxc, dW[:, :rank].float(), dz, dacc, dA,
                dW[:, rank:rank + _KERNEL_N], dW[:, rank + _KERNEL_N:], dD,
                packed)

    dxc, dWdt, dz, dacc, dA, dWB, dWC, dD, packed = scan_dir._group_bwd(
        acc, A, WB, WC, D_skip, dout, states, last_acc, gate=z is not None,
        launch_bwd=launch)
    ddtp, dbias = packed.split([rank * E, E])
    return (dxc, torch.cat([dWdt.to(dWB.dtype), dWB, dWC], 1),
            ddtp.view(rank, E), dbias, dA, dD, dz, dacc)


def _launch_groups_bwd(xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, dout,
                       states, last_acc, *, reverse, chunk_size):
    """The backward kernel over any N (``_group_bwd``); gradients in the
    kernel's dtype (float32 for a bfloat16 chain), cast by the caller."""
    xc, z, acc, dout = _wide(A.shape[-1], xc, z, acc, dout)

    def launch_bwd(W_g, A_g, D_g, z_g, acc_g, dout_g, states_g):
        return _launch_bwd(xc, W_g, dt_proj, dt_bias, A_g, D_g, z_g, acc_g,
                           dout_g, states_g, reverse=reverse,
                           chunk_size=chunk_size)

    return _group_bwd(x_proj, A, D_skip, z, acc, dout, states, last_acc,
                      launch_bwd=launch_bwd)


def _forward(xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, *, reverse,
             chunk_size, return_states):
    """(out, states or None, the last group's acc): the kernels for CUDA
    tensors (counted), the plain version for CPU tensors."""
    global LAUNCHES
    args = (xc, x_proj, dt_proj, dt_bias, A, D_skip)
    kw = dict(reverse=reverse, chunk_size=chunk_size,
              return_states=return_states)
    if xc.device.type == "cpu":
        out = mamba_scan_proj_ref(*args, z=z, acc=acc, **kw)
        return (*out, None) if return_states else (out, None, None)
    out = _launch_groups(*args, z, acc, **kw)
    LAUNCHES += _groups(A.shape[-1])
    return out


class _ProjScan(torch.autograd.Function):
    """The projection-fused scan with its backward (the custom VJP of the
    JAX package's ``_make_proj_core``). CUDA tensors run the kernels, CPU
    tensors the plain versions; outputs (out, chunk exit states)."""

    @staticmethod
    def forward(ctx, flags, xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc):
        reverse, chunk_size = flags
        out, states, last_acc = _forward(
            xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, reverse=reverse,
            chunk_size=chunk_size, return_states=True)
        ctx.flags = flags
        ctx.save_for_backward(xc, x_proj, dt_proj, dt_bias, A, D_skip, z,
                              acc, states, last_acc)
        ctx.mark_non_differentiable(states)
        return out, states

    @staticmethod
    def backward(ctx, dout, _dstates):
        global BWD_LAUNCHES
        reverse, chunk_size = ctx.flags
        xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc, states, last_acc = (
            ctx.saved_tensors)
        args = (xc, x_proj, dt_proj, dt_bias, A, D_skip)
        if xc.device.type == "cpu":
            grads = mamba_scan_proj_bwd_ref(*args, dout, z=z, acc=acc,
                                            reverse=reverse,
                                            chunk_size=chunk_size)
        else:
            grads = _launch_groups_bwd(*args, z, acc, dout, states, last_acc,
                                       reverse=reverse, chunk_size=chunk_size)
            BWD_LAUNCHES += _groups(A.shape[-1])
        inputs = args + (z, acc)
        return (None,) + tuple(
            None if g is None or not need else g.to(t.dtype)
            for g, t, need in zip(grads, inputs, ctx.needs_input_grad[1:]))


def mamba_scan_proj(xc, x_proj, dt_proj, dt_bias, A, D_skip, *, z=None,
                    acc=None, reverse=False, chunk_size=DEF_CHUNK,
                    return_states=False):
    """Projection-fused direction-aware gated scan.

    xc: (batch, L, d_inner) conv output (post-silu), float32 or bfloat16,
    at a d_inner, dt_rank and chunk that ``proj_scan_supported`` takes (on
    every device, so that CPU and CUDA take the same calls); x_proj:
    (d_inner, dt_rank + 2 N) combined projection; dt_proj: (dt_rank,
    d_inner); dt_bias: (d_inner,); A: (d_inner, N) negative real (any N:
    ceil(N / 16) launches); D_skip: (d_inner,). z and acc: optional
    (batch, L, d_inner) in xc's dtype: with z the output is
    ``(y [+ acc]) * silu(z)``, without it the raw partial ``y [+ acc]``.
    ``reverse`` scans right to left in place. Returns (batch, L, d_inner)
    in xc.dtype, and with ``return_states`` the float32 chunk exit states
    (batch, nc, N, d_inner) in scan order.

    CPU tensors run the plain versions; CUDA tensors launch the kernels.
    Differentiable in every tensor argument.
    """
    N = A.shape[-1]
    E, rank, T = xc.shape[-1], x_proj.shape[-1] - 2 * N, min(chunk_size,
                                                             xc.shape[1])
    # the kernels' I/O dtype: a bfloat16 chain of groups runs in float32
    io = xc.dtype if _groups(N) == 1 else torch.float32
    if not proj_scan_supported(E, rank, T, io):
        raise _unsupported(E, rank, T)
    inputs = (xc, x_proj, dt_proj, dt_bias, A, D_skip, z, acc)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        out, states = _ProjScan.apply((bool(reverse), chunk_size), *inputs)
        return (out, states) if return_states else out
    out, states, _ = _forward(xc, x_proj, dt_proj, dt_bias, A, D_skip, z,
                              acc, reverse=bool(reverse),
                              chunk_size=chunk_size,
                              return_states=return_states)
    return (out, states) if return_states else out
