"""3x3x3 stride-1 SAME convolution, channels-last, no bias (K9), with its
gradient.

Port of ``segmamba_tpu/ops/conv3d_pallas.py``: ``conv3d_k3s1`` (:82) and
its custom VJP (``_conv3d_fwd`` / ``_conv3d_bwd`` :135-149),
``conv3d_k3s1_v2`` (:296) and ``conv3d_k3s1_supported`` (:316). The Pallas
kernels ``_kernel`` (:59) and ``_kernel_v2`` (:212) run here as the
hand-written Hopper kernel ``csrc/conv3d_k3s1_fwd.cu`` and ``_dw_kernel``
(:152) as ``csrc/conv3d_k3s1_dw.cu``::

    y[b, d, h, w, co] = sum_{kd, kh, kw, ci}
                        x[b, d+kd-1, h+kh-1, w+kw-1, ci] w[kd, kh, kw, ci, co]

Layouts are JAX's at every public function: x (B, D, H, W, Cin), w
(3, 3, 3, Cin, Cout) (DHWIO), y (B, D, H, W, Cout) in x.dtype; w is cast
to x.dtype first, as JAX casts its folded weights. Sums are float32.

- ``conv3d_k3s1`` takes CPU tensors to the plain versions and CUDA tensors
  to the kernels; any other device raises. There is no fallback. With
  grad enabled and an input that requires it, the call goes through
  ``_Conv3dK3S1`` (a ``torch.autograd.Function``): dx is the same kernel
  on dy with ``flip(w, (0, 1, 2)).swapaxes(3, 4)`` (JAX :139-143; in bf16
  the weight-packing kernel flips and transposes as it packs), dw the dw
  kernel (float32 partials, added in part order by a second kernel),
  returned in w.dtype.
- ``conv3d_k3s1_v2`` computes the same function. Its ``kpad`` / ``npad``
  (JAX ``_pick_pads`` :258-261) are TPU lane padding; on the card it is the
  same kernel, kept as an entry point so that its counterpart is found.
- ``conv3d_k3s1_supported`` gives JAX's answers, its 192-channel VMEM limit
  included; the card's kernel itself takes any channel count.
- ``conv3d_k3s1_ref`` / ``conv3d_k3s1_dw_ref`` are the plain versions: 27
  shifted products over a zero-padded x, summed in float32 (not
  ``F.conv3d``, which is the yardstick).
- ``LAUNCHES`` counts forward-kernel launches (the forward and dx),
  ``DW_LAUNCHES`` dw-kernel launches (the weight packing and the partials'
  reduction are not counted).
- bf16 (the wgmma kernels): ``_pick_n`` chooses the forward's output-channel
  tile, ``pack_weights_ref`` is the plain version of the packed weight
  layout the kernel reads, ``_dw_plan`` sizes the dw partials to about one
  wave of blocks.

bf16: JAX stores its P tile in x.dtype before the 9-term sum (:68-72), so it
rounds 9 partials; the kernel sums all 27 Cin terms in float32 and rounds
once. bf16 parity with JAX holds at the bf16 tier, float32 parity tightly.
Layout: the port's models keep NCDHW ``F.conv3d`` and do not call this op,
as the JAX models do not call theirs; routing them here would be a
feature the JAX package lacks.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from segmamba_tpu_torch.ops import _build
from segmamba_tpu_torch.ops.scan_dir import _IO_DTYPES, _check_cuda, _ptr

LAUNCHES = 0
DW_LAUNCHES = 0
_FWD_LIB_NAME = "conv3d_k3s1_fwd"
_DW_LIB_NAME = "conv3d_k3s1_dw"
_CK = 16                       # input channels per stage of the kernels
_NF = (1, 2, 4, 6, 8)          # float32: output-channel tiles of 8 NF
_N_TILES = (16, 32, 48, 64, 96, 128, 192)   # bf16: output-channel tiles
_DW_TILE = (8, 16)             # (h, w) positions per dw step
_DW_BLOCKS_PER_SM = 8          # float32 dw blocks to aim for, per SM
_DW_PART_BYTES = 512 * 2 ** 20  # cap on the dw partials
_DW_CO = 64                    # bf16 dw: output channels per block (M)
_DW_UNITS_PER_PART = 4         # bf16 dw: units a part walks, at least


def _round_up(x, m):
    return -(-x // m) * m


def _shifts(x):
    """The 27 views of x zero-padded by 1 in (D, H, W): tap (kd, kh, kw)
    holds x[b, d+kd-1, h+kh-1, w+kw-1] at (b, d, h, w)."""
    _, D, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    return [xp[:, kd:kd + D, kh:kh + H, kw:kw + W]
            for kd in range(3) for kh in range(3) for kw in range(3)]


def conv3d_k3s1_ref(x, w):
    """Plain PyTorch version of ``conv3d_k3s1``: x (B, D, H, W, Cin), w
    (3, 3, 3, Cin, Cout); 27 shifted products summed in float32; y in
    x.dtype."""
    wf = w.to(x.dtype).float().reshape(27, *w.shape[3:])
    y = None
    for k, xs in enumerate(_shifts(x.float())):
        t = xs @ wf[k]
        y = t if y is None else y + t
    return y.to(x.dtype)


def conv3d_k3s1_dw_ref(x, dy):
    """Plain PyTorch weight gradient: dw[kd, kh, kw, ci, co] = sum over
    positions of x[pos + k - 1, ci] dy[pos, co], float32 (3, 3, 3, Cin,
    Cout)."""
    cin, cout = x.shape[-1], dy.shape[-1]
    dyf = dy.float().reshape(-1, cout)
    dw = torch.stack([xs.reshape(-1, cin).t() @ dyf
                      for xs in _shifts(x.float())])
    return dw.reshape(3, 3, 3, cin, cout)


def _pick_nf(cout):
    """Output-channel tile NT = 8 NF of the float32 forward: the NF of
    ``_NF`` whose tiles pad Cout least (ties to the larger tile)."""
    return min(reversed(_NF), key=lambda nf: _round_up(cout, 8 * nf))


def _pick_n(cout):
    """(N, tiles): the bf16 forward's output-channel tile. The whole Cout in
    one tile where one of ``_N_TILES`` holds it (the narrowest that does);
    above 192, the width of 64 or more whose tiles pad Cout least (ties to
    the wider)."""
    if cout <= _N_TILES[-1]:
        n = next(t for t in _N_TILES if t >= cout)
    else:
        n = min(reversed(_N_TILES[3:]), key=lambda t: _round_up(cout, t))
    return n, -(-cout // n)


def pack_weights_ref(w, cin, cout, n, flip=False):
    """Plain version of the bf16 kernel's packed weights (what
    ``conv3d_k3s1_pack`` writes): [n tile][kd][chunk of 16 input
    channels][tap kh kw][channel group of 8][N][8] in bfloat16, zero beyond
    (cin, cout). ``w`` (3, 3, 3, cin, cout); ``flip``: w is a forward's
    (3, 3, 3, cout, cin), taken as ``_flip_w(w)`` (dx). Flat."""
    if flip:
        w = _flip_w(w)
    ntn, nch = -(-cout // n), -(-cin // _CK)
    wp = torch.zeros((3, 3, 3, nch * _CK, ntn * n), dtype=torch.bfloat16,
                     device=w.device)
    wp[..., :cin, :cout] = w.to(torch.bfloat16)
    wp = wp.reshape(3, 9, nch, 2, 8, ntn, n)     # kd, tap, c, g, e, nt, n
    return wp.permute(5, 0, 2, 1, 3, 6, 4).reshape(-1)


def _check(x, w_or_dy, name, channels):
    _check_cuda(x)
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _IO_DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if w_or_dy.device != x.device:
        raise ValueError(f"{name} on {w_or_dy.device}, x on {x.device}")
    if channels != x.shape[-1]:
        raise ValueError(f"{name}: {channels} input channels, x has "
                         f"{x.shape[-1]}")
    if x.shape[0] * x.shape[1] > 65535:
        raise ValueError(f"B * D = {x.shape[0] * x.shape[1]} > 65535")


def _run_fwd(lib, stream, x, w, flip=False):
    """Validate and call ``conv3d_k3s1_fwd``: y = conv(x, w), or conv(x,
    ``_flip_w(w)``) with ``flip`` (dx). bf16 packs the weights with
    ``conv3d_k3s1_pack`` (one launch, flip included); float32 packs them
    as (27, cout_pad, cin_pad) with torch."""
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"w must be (3, 3, 3, Cin, Cout), got "
                         f"{tuple(w.shape)}")
    cin, cout = (w.shape[4], w.shape[3]) if flip else (w.shape[3], w.shape[4])
    _check(x, w, "w", cin)
    x = _aligned(x.contiguous())
    B, D, H, W, _ = x.shape
    if x.dtype == torch.bfloat16:
        if cin % 2:                 # the kernel stages channel pairs
            x = F.pad(x, (0, 1))
        kin = x.shape[-1]
        n, ntn = _pick_n(cout)
        nch = -(-kin // _CK)
        w = w.contiguous()
        if w.dtype not in _IO_DTYPES:
            w = w.float()
        wp = torch.empty(ntn * 3 * nch * 9 * 2 * n * 8, dtype=torch.bfloat16,
                         device=x.device)
        _raise(lib, "conv3d_k3s1_pack", lib.conv3d_k3s1_pack(
            _ptr(w), int(w.dtype == torch.bfloat16), _ptr(wp), cin, cout, nch,
            n, ntn, int(flip), stream))
        cin_pad, cout_pad, nf = nch * _CK, ntn * n, n // 8
    else:
        if flip:
            w = _flip_w(w)
        kin, nf = cin, _pick_nf(cout)
        cin_pad, cout_pad = _round_up(cin, _CK), _round_up(cout, 8 * nf)
        wp = torch.zeros((27, cout_pad, cin_pad), dtype=x.dtype,
                         device=x.device)
        wp[:, :cout, :cin] = w.to(x.dtype).reshape(27, cin, cout).transpose(
            1, 2)
    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    _raise(lib, "conv3d_k3s1_fwd", lib.conv3d_k3s1_fwd(
        _ptr(x), _ptr(wp), _ptr(y), int(x.dtype == torch.bfloat16), B, D, H,
        W, kin, cout, cin_pad, cout_pad, nf, stream))
    return y


def _raise(lib, fn, err):
    if err != 0:
        msg = lib.conv3d_k3s1_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({err})")


def _aligned(t):
    """t, or a copy of it whose data starts on 16 bytes (the kernels read
    8-channel groups as 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dw_parts(x, cout):
    """(partials, position tiles) of the float32 dw kernel: float32
    partials enough to fill x's card (``_DW_BLOCKS_PER_SM`` blocks per SM),
    no more than the position tiles, within the byte cap; each partial sums
    every nparts-th tile."""
    B, D, H, W, cin = x.shape
    tiles = B * D * -(-H // _DW_TILE[0]) * -(-W // _DW_TILE[1])
    tile_blocks = 3 * -(-cin // 32) * -(-cout // 32)
    target = _DW_BLOCKS_PER_SM * _sm_count(x.device)
    cap = max(1, _DW_PART_BYTES // (27 * cin * cout * 4))
    return max(1, min(tiles, cap, -(-target // tile_blocks))), tiles


def _dw_plan(shape, cout, sms):
    """The bf16 dw kernel's work split for x of ``shape`` (B, D, H, W, Cin):
    (nci, nparts, dsplit, units). nci input channels per block (24 where
    Cin % 24 == 0, 8 for Cin <= 8, else 16), 64 output channels; nparts
    partials so that nparts x (channel tiles) blocks are about one wave on
    ``sms`` SMs (one block per SM); the planes split into dsplit ranges so
    that a part walks about ``_DW_UNITS_PER_PART`` units (8 x 16 columns
    over a plane range) or more."""
    B, D, H, W, cin = shape
    nci = 8 if cin <= 8 else (24 if cin % 24 == 0 else 16)
    ctiles = -(-cin // nci) * -(-cout // _DW_CO)
    columns = B * -(-H // _DW_TILE[0]) * -(-W // _DW_TILE[1])
    target = max(1, sms // ctiles)
    dsplit = min(D, max(1, -(-_DW_UNITS_PER_PART * target // columns)))
    dr = -(-D // dsplit)
    dsplit = -(-D // dr)
    units = columns * dsplit
    return nci, min(target, units), dsplit, units


def _run_dw(lib, stream, x, dy):
    """Validate, allocate the partials, call ``conv3d_k3s1_dw`` and add the
    partials with ``conv3d_k3s1_dw_reduce``: float32 (3, 3, 3, Cin,
    Cout)."""
    _check(x, dy, "dy", x.shape[-1])
    x = _aligned(x.contiguous())
    dy = _aligned(dy.to(x.dtype).contiguous())
    if dy.shape[:4] != x.shape[:4]:
        raise ValueError(f"dy {tuple(dy.shape)} vs x {tuple(x.shape)}")
    cin, cout = x.shape[4], dy.shape[4]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (cin % 2 or cout % 2):   # the kernel stages channel pairs
        x, dy = F.pad(x, (0, cin % 2)), F.pad(dy, (0, cout % 2))
    B, D, H, W, kin = x.shape
    kout = dy.shape[4]
    if bf16:
        nci, nparts, dsplit, _ = _dw_plan(x.shape, kout, _sm_count(x.device))
        nf = nci // 8
    else:
        nf, nparts, dsplit = 1, _dw_parts(x, kout)[0], 1
    part = torch.empty((nparts, 27, kin, kout), dtype=torch.float32,
                       device=x.device)
    err = lib.conv3d_k3s1_dw(
        _ptr(x), _ptr(dy), _ptr(part), int(bf16), B, D, H, W, kin, kout, nf,
        nparts, dsplit, stream)
    if err == 0:
        dw = torch.empty((3, 3, 3, kin, kout), dtype=torch.float32,
                         device=x.device)
        err = lib.conv3d_k3s1_dw_reduce(_ptr(part), _ptr(dw), nparts,
                                        dw.numel(), stream)
    if err != 0:
        msg = lib.conv3d_k3s1_dw_error_string(err).decode()
        raise RuntimeError(f"conv3d_k3s1_dw launch failed: {msg} ({err})")
    return dw if (kin, kout) == (cin, cout) else dw[..., :cin, :cout]


_SMS = {}


def _sm_count(device):
    """SMs of ``device``'s card (read once per card)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


_LIBS = {}


def _lib():
    """The forward kernel library with its C signature declared (built on
    first use)."""
    if "fwd" not in _LIBS:
        lib = _build.load_library(_FWD_LIB_NAME)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3d_k3s1_fwd.argtypes = [vp] * 3 + [i] * 10 + [vp]
        lib.conv3d_k3s1_fwd.restype = i
        lib.conv3d_k3s1_pack.argtypes = [vp, i, vp] + [i] * 6 + [vp]
        lib.conv3d_k3s1_pack.restype = i
        lib.conv3d_k3s1_error_string.argtypes = [i]
        lib.conv3d_k3s1_error_string.restype = ctypes.c_char_p
        _LIBS["fwd"] = lib
    return _LIBS["fwd"]


def _dw_lib():
    """The dw kernel library with its C signature declared (built on first
    use)."""
    if "dw" not in _LIBS:
        lib = _build.load_library(_DW_LIB_NAME)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3d_k3s1_dw.argtypes = [vp] * 3 + [i] * 10 + [vp]
        lib.conv3d_k3s1_dw.restype = i
        lib.conv3d_k3s1_dw_reduce.argtypes = [vp, vp, i, ctypes.c_longlong,
                                              vp]
        lib.conv3d_k3s1_dw_reduce.restype = i
        lib.conv3d_k3s1_dw_error_string.argtypes = [i]
        lib.conv3d_k3s1_dw_error_string.restype = ctypes.c_char_p
        _LIBS["dw"] = lib
    return _LIBS["dw"]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(x, w, flip=False):
    """The forward kernel on the current stream of x's card (``flip``: on
    ``_flip_w(w)``, dx)."""
    _check_cuda(x)
    with torch.cuda.device(x.device):
        return _run_fwd(_lib(), _stream(x), x, w, flip)


def _launch_dw(x, dy):
    """The dw kernel on the current stream of x's card."""
    _check_cuda(x)
    with torch.cuda.device(x.device):
        return _run_dw(_dw_lib(), _stream(x), x, dy)


def _flip_w(w):
    """The weights of dx = conv(dy, .): flipped taps, (Cout, Cin) swapped."""
    return torch.flip(w, (0, 1, 2)).transpose(3, 4)


def _forward(x, w, flip=False):
    """y = conv(x, w) (``flip``: conv(x, ``_flip_w(w)``), dx): the kernel
    for CUDA tensors (counted), the plain version for CPU tensors."""
    global LAUNCHES
    if x.device.type == "cpu":
        return conv3d_k3s1_ref(x, _flip_w(w) if flip else w)
    y = _launch(x, w, flip)
    LAUNCHES += 1
    return y


def _dw(x, dy):
    """dw (float32): the kernel for CUDA tensors (counted), the plain
    version for CPU tensors."""
    global DW_LAUNCHES
    if x.device.type == "cpu":
        return conv3d_k3s1_dw_ref(x, dy)
    dw = _launch_dw(x, dy)
    DW_LAUNCHES += 1
    return dw


class _Conv3dK3S1(torch.autograd.Function):
    """The conv with its backward (the custom VJP of the JAX package's
    ``conv3d_k3s1``). CUDA tensors run the kernels, CPU tensors the plain
    versions."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _forward(dy.to(x.dtype), w, flip=True)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, dy).to(w.dtype)
        return dx, dw


def conv3d_k3s1(x, w):
    """3-D conv, kernel 3, stride 1, SAME padding, channels-last, no bias.

    x: (B, D, H, W, Cin) float32 or bfloat16; w: (3, 3, 3, Cin, Cout).
    Returns (B, D, H, W, Cout) in x.dtype (float32 sums inside). CPU
    tensors run the plain versions; CUDA tensors launch the kernels.
    Differentiable in x and w.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3dK3S1.apply(x, w)
    return _forward(x, w)


def conv3d_k3s1_v2(x, w):
    """JAX's lane-aligned P-form entry: the same function as
    ``conv3d_k3s1`` (its lane padding is a TPU layout rule), the same
    kernel on the card."""
    return conv3d_k3s1(x, w)


def conv3d_k3s1_supported(x_shape, w_shape):
    """Whether the JAX package's Pallas path takes this conv (k3, s1,
    SAME, 5-D, at most 192 channels each way, JAX :316-331). The card's
    kernel takes any channel count; callers that choose between this op
    and another by JAX's rule keep the same choice."""
    if len(w_shape) != 5 or tuple(w_shape[:3]) != (3, 3, 3):
        return False
    if len(x_shape) != 5:
        return False
    _, d, h, w, cin = x_shape
    cout = w_shape[-1]
    if cin > 192 or cout > 192:
        return False
    return d >= 1 and h >= 1 and w >= 1
