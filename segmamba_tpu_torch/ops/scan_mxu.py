"""Matrix-unit selective-scan core (K7), forward and backward: the
ratio-form sub-block scan.

Port of ``segmamba_tpu/ops/scan_pallas_mxu.py`` ``selective_scan_mxu``
(:379-428) and its guarded custom VJP (``_make_core`` :335-371). The Pallas
kernels ``_fwd_kernel`` (:131) and ``_bwd_kernel`` (:165), with their
helpers ``_block_scan`` (:107) and ``_masks`` (:82), run here as the
hand-written Hopper kernels ``mxu_fwd_kernel`` and ``mxu_bwd_kernel``: the
``RATIO`` instances of the single-pass look-back templates
``csrc/gated_scan_fwd.cu`` and ``csrc/gated_scan_bwd.cu`` (K1-K6's), one
launch per call and group of 16 states each way, built into those
templates' libraries. The function is K6's core (``scan_core``)::

    (u, delta, A, B, C) -> (y, chunk exit states),  y_t = C_t . x_t

computed in K7's arithmetic. Within each sub-block of S steps, per row,
channel d and state n, with b = delta u B::

    Delta[t] = in-sub-block cumulative sum of delta,  l = Delta A
    P = exp(l),  Pinv = exp(-max(l, -MAX_BLOCK_DROP - 10))
    x[t] = P[t] (sum_{s <= t} b[s] Pinv[s]) + P[t] c      (x_blk + P carry)
    c <- P_end c + x_blk_end                             (across sub-blocks)

(``l`` is ``A`` times the cumulative sum of delta: the same sum as JAX's
cumulative sum of ``delta A``, one product per state instead of one per
step.)

The overflow guard. ``1 / P`` spans the sub-block's decay ``exp(drop)``.
JAX bounds the worst drop of the whole call (``_block_drop``: the largest
sub-block sum of |delta| of any channel times the largest |A|) and, past
``MAX_BLOCK_DROP``, sends the whole call to the Hillis-Steele kernel K6
through ``lax.cond``; with real softplus deltas that bound always trips.
The port decides per unit instead, on the card and in the kernel: for each
(row, channel d, state n, sub-block k)::

    drop = |A[d, n]| * sum_{t in k} |delta[t, d]|

below ``MAX_BLOCK_DROP`` the unit takes the ratio form, otherwise the step
recurrence ``x_t = exp(delta A) x_{t-1} + b_t``; the carry across sub-blocks
is the same in both. A unit's drop never exceeds JAX's bound, so every unit
JAX sends to the ratio form goes there here too, and the result is exact
in both forms (the f32 tier). No host sync, no second kernel; the backward
recomputes the same decision from the same serial sum of the same values.
``guarded=False`` is JAX's unguarded kernel: the ratio form everywhere,
with the NaN-guard clamp of ``Pinv`` (:150-152).

The kernels' schedule (the sources say more): the forward's sweep 1 runs
each chunk from zero in this arithmetic (its exit the chunk's aggregate),
a decoupled look-back folds the aggregates, exp(A sum delta) x + agg, and
sweep 2 writes y and the exit state from the entry state in the same
arithmetic. The backward's sweep F rebuilds x from the
forward's chunk states, checkpointing the ratio form's running value in
shared memory, and forms the chunk's adjoint aggregate; a reverse look-back
hands each chunk its adjoint entry; sweep B replays and walks the adjoint
in the same forms (JAX's upper-triangular sums, :204-225).

- ``selective_scan_mxu`` takes CPU tensors to the plain versions and CUDA
  tensors to the kernels; any other device raises. There is no fallback.
  The kernels are built for 16 states; another N (up to 256, as JAX) runs
  as ceil(N / 16) launches over groups of 16 states, as ``scan_core`` does
  for K6. With grad enabled the call goes through ``_MxuCore`` (a
  ``torch.autograd.Function``) whose backward takes ``dy`` and ``dlast``.
- Chunk and sub-block lengths are JAX's (``_geometry``, JAX :397-402):
  T = min(chunk, round_up(L, 8)) (at least min(128, round_up(L, 8))),
  S = min(sub_block, T), S = T where S does not divide T. A ragged L stops
  at the last real step (JAX pads with delta = 0, identity steps).
- ``selective_scan_mxu_core_ref`` is the plain forward: the same per-unit
  guard in torch (cumulative sums over the sub-block axis, ``torch.where``
  between the two forms, the exponent of the branch not taken clamped to 0
  so that autograd stays finite); ``selective_scan_mxu_core_bwd_ref`` the
  plain backward, ``autograd.grad`` through it.
- ``tally()`` counts the units through each form: inside it the kernels
  get a pointer to two int64 counts (ratio, step), added to once per
  warp; outside it the pointer is null. The plain versions count too.
- ``LAUNCHES`` / ``BWD_LAUNCHES`` count this wrapper's kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from segmamba_tpu_torch.ops import scan_core, scan_dir
from segmamba_tpu_torch.ops.selective_scan import (
    _hs_scan,
    _postprocess,
    _preprocess_delta,
)

# Largest in-sub-block log-decay drop before 1/P leaves the float32 range
# (exp(88) overflows; headroom for the b magnitudes), JAX :75-78.
MAX_BLOCK_DROP = 75.0
DEF_SUB = 16
DEF_CHUNK = 128
LAUNCHES = 0
BWD_LAUNCHES = 0
_GROUP = scan_dir._KERNEL_N     # states per launch
_MAX_T = 256                    # the kernels' largest chunk


def _round_up(x, m):
    return -(-x // m) * m


def _geometry(seqlen, chunk_size=DEF_CHUNK, sub_block=DEF_SUB):
    """JAX's chunk length T and sub-block length S for a sequence of
    ``seqlen`` steps (``selective_scan_mxu`` :397-402)."""
    Lr = _round_up(seqlen, 8)
    T = min(chunk_size, Lr)
    if T < 128 and Lr > T:
        T = min(128, Lr)
    S = min(sub_block, T)
    if T % S:
        S = T       # degenerate short-sequence case: one sub-block
    return T, S


def block_drop(delta, A, sub_block):
    """JAX's call-wide guard bound (``_block_drop`` :326-332), for the tests
    and the reports: the largest sub-block sum of |delta| of any channel
    times the largest |A| of that channel; JAX takes its K6 fallback for
    the whole call when it reaches ``MAX_BLOCK_DROP``. delta (R, L, D),
    padded with zeros to whole sub-blocks as JAX pads it; A (D, N)."""
    R, L, D = delta.shape
    delta = torch.nn.functional.pad(delta, (0, 0, 0, (-L) % sub_block))
    dsum = delta.abs().reshape(R, -1, sub_block, D).sum(2)
    return float((dsum.amax((0, 1)) * A.abs().amax(-1)).max())


# ---------------------------------------------------------------------------
# the tally of units through each form
# ---------------------------------------------------------------------------


class Tally:
    """Units of (row, channel, state, sub-block) through the ratio form and
    through the step form, summed over the K7 passes run inside
    ``tally()`` (the forward and the backward each count theirs). Read
    ``ratio`` and ``step`` after the ``with`` block."""

    def __init__(self):
        self._bufs = {}
        self.ratio = self.step = 0

    def buffer(self, device):
        """The int64 (ratio, step) counts on ``device``."""
        key = str(device)
        if key not in self._bufs:
            self._bufs[key] = torch.zeros(2, dtype=torch.int64,
                                          device=device)
        return self._bufs[key]

    def share(self):
        """The ratio form's share of the units counted."""
        total = self.ratio + self.step
        return self.ratio / total if total else float("nan")

    def _close(self):
        for buf in self._bufs.values():   # one host sync, at the end
            r, s = buf.tolist()
            self.ratio += r
            self.step += s


_TALLY = None


@contextlib.contextmanager
def tally():
    """Count the units through each form of the K7 passes inside the block;
    yields the ``Tally``."""
    global _TALLY
    t, prev = Tally(), _TALLY
    _TALLY = t
    try:
        yield t
    finally:
        _TALLY = prev
        t._close()


def _tally_buffer(device):
    return None if _TALLY is None else _TALLY.buffer(device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _mxu_plain(u, delta, A, B, C, T, S, guarded):
    """K7's arithmetic in torch on float32 operands: u, delta (R, L, D), A
    (D, N) or (R, D, N), B, C (R, L, N). Returns (y (R, L, D), chunk exit
    states (R, nc, N, D))."""
    R, L, D = u.shape
    N = A.shape[-1]
    pad = (-L) % T
    if pad:   # identity steps: delta = 0, b = 0, C = 0
        zpad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
        u, delta, B, C = zpad(u), zpad(delta), zpad(B), zpad(C)
    Lp = L + pad
    nb, nc = Lp // S, Lp // T
    d = delta.reshape(R, nb, S, D, 1)
    A_t = A[:, None, None] if A.dim() == 3 else A    # vs (R, nb, S, D, N)
    A_k = A[:, None] if A.dim() == 3 else A          # vs (R, nb, D, N)
    if guarded:
        dabs = delta.reshape(R, nb, S, D).abs().sum(2)
        ratio = dabs[..., None] * A_k.abs() < MAX_BLOCK_DROP  # (R, nb, D, N)
    else:
        ratio = torch.ones(R, nb, D, N, dtype=torch.bool, device=u.device)
    buf = _tally_buffer(u.device)
    if buf is not None:   # the sub-blocks that hold a real step
        real = ratio[:, :-(-L // S)]
        n_ratio = real.sum()
        buf += torch.stack([n_ratio, real.numel() - n_ratio])
    rs = ratio[:, :, None]
    ell = d.cumsum(2) * A_t
    if guarded:   # the step units' ratio branch is not taken: exponent 0
        ell = torch.where(rs, ell, torch.zeros_like(ell))
    P = torch.exp(ell)
    Pinv = torch.exp(-torch.clamp_min(ell, -MAX_BLOCK_DROP - 10.0))
    b = (d * u.reshape(R, nb, S, D, 1)) * B.reshape(R, nb, S, 1, N)
    x_blk = P * (b * Pinv).cumsum(2)       # zero-entry in-block states
    decay, exit0 = P[:, :, -1], x_blk[:, :, -1]
    if guarded:   # the step form: products of exp(delta A) only
        a_cum, x_step = _hs_scan(torch.exp(d * A_t), b, dim=2)
        decay = torch.where(ratio, decay, a_cum[:, :, -1])
        exit0 = torch.where(ratio, exit0, x_step[:, :, -1])
    # product-form carry across sub-blocks: c_{k+1} = P_end c_k + x_blk_end
    _, exits = _hs_scan(decay, exit0, dim=1)
    c = torch.cat([torch.zeros_like(exits[:, :1]), exits[:, :-1]],
                  1)[:, :, None]
    x = x_blk + P * c
    if guarded:
        x = torch.where(rs, x, x_step + a_cum * c)
    y = torch.einsum("rbsdn,rbsn->rbsd", x, C.reshape(R, nb, S, N))
    states = x.reshape(R, nc, T, D, N)[:, :, -1].transpose(-1, -2)
    return y.reshape(R, Lp, D)[:, :L], states.contiguous()


def selective_scan_mxu_core_ref(u, delta, A, B, C, chunk_size=DEF_CHUNK,
                                sub_block=DEF_SUB, guarded=True,
                                return_states=False):
    """Plain PyTorch version of the K7 core on float32 operands: u, delta
    (R, L, D), A (D, N) or (R, D, N), B, C (R, L, N); T and S by
    ``_geometry``. Returns (y, last state (R, D, N)), or with
    ``return_states`` (y, chunk exit states (R, nc, N, D))."""
    T, S = _geometry(u.shape[1], chunk_size, sub_block)
    y, states = _mxu_plain(u, delta, A, B, C, T, S, guarded)
    return (y, states) if return_states else (
        y, scan_core._last_state(states))


def selective_scan_mxu_core_bwd_ref(u, delta, A, B, C, dy, dlast,
                                    chunk_size=DEF_CHUNK, sub_block=DEF_SUB,
                                    guarded=True):
    """Plain backward of the K7 core: ``autograd.grad`` of (y, last state)
    through ``selective_scan_mxu_core_ref`` with cotangents (dy, dlast),
    in float32. Returns (du, ddelta, dA, dB, dC) in the inputs' shapes."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_()
                  for t in (u, delta, A, B, C)]
        y, last = selective_scan_mxu_core_ref(
            *leaves, chunk_size=chunk_size, sub_block=sub_block,
            guarded=guarded)
        return torch.autograd.grad((y, last), leaves,
                                   (dy.float(), dlast.float()))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_operands(u, delta, A, B, C, T, S):
    """Validate one launch's operands (16 states). Returns (R, L, D, A as
    a float32 contiguous parameter, the 9 strides)."""
    if u.dim() != 3:
        raise ValueError(f"u must be (R, L, D), got {tuple(u.shape)}")
    R, L, D = u.shape
    if A.shape[-1] != _GROUP:
        raise ValueError(f"the K7 kernels are built for N={_GROUP}, got "
                         f"N={A.shape[-1]}")
    if not (1 <= T <= _MAX_T and 1 <= S <= T and T % S == 0):
        raise ValueError(f"chunk {T} / sub-block {S}: need S | T <= "
                         f"{_MAX_T}")
    for name, t in (("u", u), ("delta", delta), ("B", B), ("C", C)):
        if t.device != u.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {t.dtype} on {t.device}; expected "
                             f"float32 on {u.device}")
    strides = scan_dir._row_step_strides(u, "u", (R, L, D))
    strides += scan_dir._row_step_strides(delta, "delta", (R, L, D))
    strides += scan_dir._row_step_strides(B, "B", (R, L, _GROUP))
    strides += scan_dir._row_step_strides(C, "C", (R, L, _GROUP))
    Af, sA = scan_dir._param(A, "A", R, (D, _GROUP), u.device)
    return R, L, D, Af, strides + [sA]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_kernel(lib, stream, u, delta, A, B, C, T, S, guarded, n_valid=16,
                tally_buf=None):
    """Validate, allocate y, the chunk exit states and the look-back scratch
    (records and sums of delta; the flags, the first of them the chunks'
    ticket, zeroed here) on u's device and call the library's
    ``mxu_scan_fwd`` on ``stream``: one kernel. Returns (y (R, L, D),
    states (R, nc, 16, D)), float32."""
    R, L, D, Af, strides = _check_operands(u, delta, A, B, C, T, S)
    nc = -(-L // T)
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((R, L, D), **f32)
    states = torch.empty((R, nc, _GROUP, D), **f32)
    sizes = (ctypes.c_longlong * 3)()
    lib.gated_scan_fwd_scratch(R, L, D, T, sizes)
    n_st, n_sd, n_fl = sizes
    scratch = torch.empty(2 * n_st + n_sd, **f32)
    flags = torch.zeros(n_fl, dtype=torch.int32, device=u.device)
    base = scratch.data_ptr()
    err = lib.mxu_scan_fwd(
        _ptr(u), _ptr(delta), _ptr(Af), _ptr(B), _ptr(C), _ptr(y),
        _ptr(states), base, base + 4 * n_st, base + 8 * n_st, _ptr(flags),
        _ptr(tally_buf), R, L, D, T, S, int(guarded), n_valid,
        scan_dir._block_channels(D), (ctypes.c_longlong * 9)(*strides),
        stream)
    if err != 0:
        msg = lib.gated_scan_error_string(err).decode()
        raise RuntimeError(f"mxu_scan_fwd launch failed: {msg} ({err})")
    return y, states


def _run_bwd_kernel(lib, stream, u, delta, A, B, C, dy, dlast, states, T, S,
                    guarded, n_valid=16, tally_buf=None):
    """Validate, allocate every gradient and one scratch buffer (look-back
    records, the per-chunk dA and per-channel-block dB / dC partials, sums
    of delta, the flags zeroed) on u's device, call the library's
    ``mxu_scan_bwd`` on ``stream`` (one kernel) and reduce the partials
    with ``torch.sum``. ``dlast`` (R, 16, D) float32 or None, ``states``
    the forward's chunk exit states. Returns (du, ddelta, dA, dB, dC) in
    the shapes of (u, delta, A, B, C)."""
    R, L, D, Af, strides = _check_operands(u, delta, A, B, C, T, S)
    nc = -(-L // T)
    if tuple(states.shape) != (R, nc, _GROUP, D) or (
            states.dtype != torch.float32 or not states.is_contiguous()):
        raise ValueError(f"states: {tuple(states.shape)} {states.dtype}, "
                         f"expected contiguous float32 {(R, nc, _GROUP, D)}")
    dy = dy.float().contiguous()
    if tuple(dy.shape) != (R, L, D) or dy.device != u.device:
        raise ValueError(f"dy: {tuple(dy.shape)} on {dy.device}, expected "
                         f"{(R, L, D)} on {u.device}")
    if dlast is not None and (
            tuple(dlast.shape) != (R, _GROUP, D) or dlast.device != u.device
            or dlast.dtype != torch.float32 or not dlast.is_contiguous()):
        raise ValueError(f"dlast: {tuple(dlast.shape)}, expected contiguous "
                         f"float32 {(R, _GROUP, D)} on {u.device}")
    channels = scan_dir._bwd_block_channels(D)
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty((R, L, D), **f32)
    ddelta = torch.empty((R, L, D), **f32)
    # records (n_st floats each), dA partials (R, nc, D, 16), whose rows the
    # kernel writes as 16-byte vectors, dB and dC partials (nbd, R, L, 16),
    # sums of delta (n_sd), flags (n_fl ints, the first the ticket)
    sizes = (ctypes.c_longlong * 3)()
    lib.gated_scan_bwd_scratch(R, L, D, T, channels, sizes)
    n_st, n_sd, n_fl = sizes
    nbd = -(-D // channels)
    n_dA, n_bc = R * nc * D * _GROUP, nbd * R * L * _GROUP
    o_bc = 2 * n_st + n_dA
    o_sd = o_bc + 2 * n_bc
    scratch = torch.empty(o_sd + n_sd + n_fl, **f32)
    scratch[-n_fl:].zero_()
    dA_p = scratch[2 * n_st:o_bc].view(R, nc, D, _GROUP)
    dB_p, dC_p = scratch[o_bc:o_sd].view(2, nbd, R, L, _GROUP)
    at = lambda o: scratch.data_ptr() + 4 * o
    err = lib.mxu_scan_bwd(
        _ptr(u), _ptr(delta), _ptr(Af), _ptr(B), _ptr(C), _ptr(dy),
        _ptr(states), _ptr(dlast), _ptr(du), _ptr(ddelta), _ptr(dA_p),
        _ptr(dB_p), _ptr(dC_p), at(0), at(n_st), at(o_sd),
        at(o_sd + n_sd), _ptr(tally_buf), R, L, D, T, S, int(guarded),
        n_valid, channels, (ctypes.c_longlong * 9)(*strides), stream)
    if err != 0:
        msg = lib.gated_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"mxu_scan_bwd launch failed: {msg} ({err})")
    dA = dA_p.sum(1)                             # (R, D, 16)
    if A.dim() == 2:
        dA = dA.sum(0)
    return du, ddelta, dA, dB_p.sum(0), dC_p.sum(0)


_DECLARED = set()


def _lib():
    """The forward template's library (``gated_scan_fwd``, built on first
    use) with K7's entry declared."""
    lib = scan_dir._lib()
    if "fwd" not in _DECLARED:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mxu_scan_fwd.argtypes = ([vp] * 12 + [ll] * 3 + [i] * 5
                                     + [ctypes.POINTER(ll), vp])
        lib.mxu_scan_fwd.restype = i
        _DECLARED.add("fwd")
    return lib


def _bwd_lib():
    """The backward template's library (``gated_scan_bwd``, built on first
    use) with K7's entry declared."""
    lib = scan_dir._bwd_lib()
    if "bwd" not in _DECLARED:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mxu_scan_bwd.argtypes = ([vp] * 18 + [ll] * 3 + [i] * 5
                                     + [ctypes.POINTER(ll), vp])
        lib.mxu_scan_bwd.restype = i
        _DECLARED.add("bwd")
    return lib


def _valid(N, g):
    """Real states in group ``g`` (the tally counts only those)."""
    return min(_GROUP, N - g * _GROUP)


def _launch(u, delta, A, B, C, T, S, guarded):
    """K7 forward on the card: (y, chunk exit states (R, nc, N, D)), one
    launch per group of 16 states."""
    scan_dir._check_cuda(u)
    N, buf = A.shape[-1], _tally_buffer(u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        return scan_core._group_forward(
            A, B, C, lambda A_g, B_g, C_g, g: _run_kernel(
                _lib(), stream, u, delta, A_g, B_g, C_g, T, S, guarded,
                _valid(N, g), buf))


def _launch_bwd(u, delta, A, B, C, dy, dlast, states, T, S, guarded):
    """K7 backward on the card: (du, ddelta, dA, dB, dC), one launch per
    group of 16 states."""
    scan_dir._check_cuda(u)
    N, buf = A.shape[-1], _tally_buffer(u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        return scan_core._group_backward(
            A, B, C, dlast, states,
            lambda A_g, B_g, C_g, dlast_g, states_g, g: _run_bwd_kernel(
                _bwd_lib(), stream, u, delta, A_g, B_g, C_g, dy, dlast_g,
                states_g, T, S, guarded, _valid(N, g), buf))


def _forward(u, delta, A, B, C, T, S, guarded):
    """(y, chunk exit states): the kernel for CUDA tensors (counted), the
    plain version for CPU tensors."""
    global LAUNCHES
    if u.device.type == "cpu":
        return _mxu_plain(u, delta, A, B, C, T, S, guarded)
    out = _launch(u, delta, A, B, C, T, S, guarded)
    LAUNCHES += scan_core._groups(A.shape[-1])
    return out


class _MxuCore(torch.autograd.Function):
    """The K7 core with its backward (the custom VJP of the JAX package's
    ``scan_pallas_mxu._make_core``). CUDA tensors run the kernels, CPU
    tensors the plain versions; outputs (y, last state)."""

    @staticmethod
    def forward(ctx, T, S, guarded, u, delta, A, B, C):
        y, states = _forward(u, delta, A, B, C, T, S, guarded)
        ctx.geometry = (T, S, guarded)
        ctx.save_for_backward(u, delta, A, B, C, states)
        return y, scan_core._last_state(states)

    @staticmethod
    def backward(ctx, dy, dlast):
        global BWD_LAUNCHES
        u, delta, A, B, C, states = ctx.saved_tensors
        T, S, guarded = ctx.geometry
        if u.device.type == "cpu":   # (T, S) is a fixed point of _geometry
            grads = selective_scan_mxu_core_bwd_ref(
                u, delta, A, B, C, dy, dlast, T, S, guarded)
        else:
            grads = _launch_bwd(u, delta, A, B, C, dy, dlast, states, T, S,
                                guarded)
            BWD_LAUNCHES += scan_core._groups(A.shape[-1])
        return (None, None, None) + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[3:]))


def _core(u, delta, A, B, C, T, S, guarded):
    """Route one core call: through ``_MxuCore`` when a gradient is to be
    recorded, else straight to the kernel (CUDA) or the plain forward
    (CPU). Returns (y, last state (R, D, N))."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, delta, A, B, C)):
        return _MxuCore.apply(T, S, guarded, u, delta, A, B, C)
    y, states = _forward(u, delta, A, B, C, T, S, guarded)
    return y, scan_core._last_state(states)


def selective_scan_mxu(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, return_last_state=False,
                       chunk_size=DEF_CHUNK, d_block=256, sub_block=DEF_SUB,
                       guarded=True):
    """Selective scan through the K7 core; the contract of JAX's
    ``selective_scan_mxu``: time-major u, delta, z (batch, L, dim),
    time-varying B, C (batch, L, N), A (dim, N) (or per row (batch, dim,
    N)), D and delta_bias (dim,) or (batch, dim). Returns out (batch, L,
    dim) in u.dtype, and the float32 last state (batch, dim, N) with
    ``return_last_state``. ``guarded`` picks the form per unit (module
    note); ``guarded=False`` takes the ratio form everywhere.

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    (one launch per 16 states, N <= 256). ``d_block`` is accepted for
    JAX's signature: the card's channel blocks are the kernels' thread
    blocks. Differentiable in every tensor argument.
    """
    if B.dim() != 3 or C.dim() != 3:
        raise ValueError("the K7 kernel needs time-varying (batch, L, N) "
                         "B and C")
    if A.shape[-1] > 256:
        raise ValueError(f"dstate must be <= 256, got {A.shape[-1]}")
    T, S = _geometry(u.shape[1], chunk_size, sub_block)
    d = _preprocess_delta(delta, delta_bias, delta_softplus)
    y, last = _core(u.float(), d, A.float(), B.float(), C.float(), T, S,
                    guarded)
    out = _postprocess(y, u, D, z, u.dtype)
    return (out, last) if return_last_state else out
