"""Depthwise causal 1-D convolution, time-major, in plain PyTorch.

Port of ``segmamba_tpu/ops/causal_conv1d.py`` ``causal_conv1d``,
``causal_conv1d_grouped``, ``causal_conv1d_directional`` (G = 2 and G = 3)
and the decode step ``causal_conv1d_update``. In the JAX package these
are XLA ops (shifted multiply-adds); here they are the same shifted
multiply-adds in torch, computed in float32 and cast back to x's dtype.
Layout is time-major ``(batch, L, dim)``; filters are ``(width, dim)`` as in
the JAX package (the torch ``Conv1d`` weight ``(dim, 1, width)`` transposed).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _activate(y, activation):
    if activation in ("silu", "swish"):
        return F.silu(y)
    return y


def _check_activation(activation):
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")


def causal_conv1d(x, weight, bias=None, activation=None):
    """y[t, d] = act(sum_w weight[w, d] * x[t - (W-1) + w, d] + bias[d]).

    x: (batch, L, dim); weight: (width, dim); bias: (dim,) or None;
    activation: None or "silu". Returns (batch, L, dim) in x.dtype.
    """
    _check_activation(activation)
    width, dim = weight.shape
    if x.shape[-1] != dim:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)} vs weight "
                         f"{tuple(weight.shape)}")
    seqlen = x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    w = weight.float()
    y = torch.zeros_like(xp[:, :seqlen])
    for i in range(width):
        y = y + w[i] * xp[:, i:i + seqlen]
    if bias is not None:
        y = y + bias.float()
    return _activate(y, activation).to(x.dtype)


def causal_conv1d_grouped(x, weight, bias, batch, activation=None):
    """Depthwise causal conv with per-group filters: row i of x uses filter
    i // batch (the three scan orientations folded into one batched op).

    x: (groups * batch, L, dim); weight: (groups, width, dim); bias:
    (groups, dim) or None. Returns (groups * batch, L, dim) in x.dtype.
    """
    _check_activation(activation)
    groups, width, dim = weight.shape
    if x.shape[0] != groups * batch or x.shape[-1] != dim:
        raise ValueError(f"x {tuple(x.shape)} vs weight "
                         f"{tuple(weight.shape)} and batch {batch}")
    seqlen = x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    w = weight.float().repeat_interleave(batch, dim=0)    # (g b, W, dim)
    y = torch.zeros_like(xp[:, :seqlen])
    for i in range(width):
        y = y + w[:, i, None, :] * xp[:, i:i + seqlen]
    if bias is not None:
        y = y + bias.float().repeat_interleave(batch, dim=0)[:, None, :]
    return _activate(y, activation).to(x.dtype)


def causal_conv1d_directional(x, weight, bias, activation=None,
                              nslices=None):
    """Depthwise causal conv for every scan orientation on the original
    layout (no reordered copies of x):

    - group 0 (forward): y[t] = act(sum_i w[i] x[t-(W-1)+i] + b)
    - group 1 (flip):    flip(conv(flip(x))), the anticausal conv
    - group 2 (slice):   the conv in slice-interleaved order; with x viewed
                         as (S, P) slices x positions, the interleaved
                         predecessor of (s, p) is (s-1, p), wrapping to
                         (S-1, p-1) at s = 0. Where a tap reaches k >= S
                         tokens back (S < width - 1), the shift runs on an
                         interleaved copy: the JAX function's one-position
                         carry gives wrong values there (S = 2) or raises
                         (S = 1).

    x: (batch, L, dim); weight: (G, width, dim), G in {2, 3}, groups ordered
    [forward, flip, slice]; bias: (G, dim) or None; nslices: S (G = 3).
    Returns (G, batch, L, dim) in x.dtype, original token order per group.
    """
    _check_activation(activation)
    G, width, dim = weight.shape
    batch, seqlen, _ = x.shape
    xf = x.float()
    w = weight.float()

    def shifted(i, direction):
        """x[t + direction * (i - (W-1))] with zero fill (time axis)."""
        off = i - (width - 1)
        if direction < 0:
            off = -off
        if off == 0:
            return xf
        k = min(abs(off), seqlen)     # a shift past the whole sequence
        if off < 0:
            return F.pad(xf[:, :seqlen - k], (0, 0, k, 0))
        return F.pad(xf[:, k:], (0, 0, 0, k))

    outs = []
    for g, direction in ((0, +1), (1, -1)):
        y = torch.zeros_like(xf)
        for i in range(width):
            y = y + w[g, i] * shifted(i, direction)
        outs.append(y)

    if G == 3:
        if nslices is None or seqlen % nslices != 0:
            raise ValueError("slice group needs nslices dividing L")
        S, P = nslices, seqlen // nslices
        xg = xf.reshape(batch, S, P, dim)
        # interleaved order as (P, S): token (q - k) of q = (p, s)
        xil = xg.transpose(1, 2)

        def slice_shifted(k):
            """Token (q - k) of the interleaved order, original layout."""
            if k == 0:
                return xf
            if k >= S:
                # a shift of k >= S crosses more than one position; the
                # JAX package's one-position carry (below) is wrong there
                # (silently for S = 2 at width 4, an error for S = 1), so
                # shift the flattened interleaved order itself
                flat = F.pad(xil.reshape(batch, seqlen, dim)[:, :seqlen - k],
                             (0, 0, k, 0))
                return flat.reshape(batch, P, S, dim).transpose(1, 2).reshape(
                    batch, seqlen, dim)
            upper = xg[:, :S - k]
            wrap = F.pad(xg[:, S - k:, :P - 1], (0, 0, 1, 0))
            return torch.cat([wrap, upper], dim=1).reshape(batch, seqlen, dim)

        y = torch.zeros_like(xf)
        for i in range(width):
            y = y + w[2, i] * slice_shifted(width - 1 - i)
        outs.append(y)

    y = torch.stack(outs)                                  # (G, b, L, dim)
    if bias is not None:
        y = y + bias.float()[:, None, None, :]
    return _activate(y, activation).to(x.dtype)


def causal_conv1d_update(x_new, conv_state, weight, bias=None,
                         activation=None):
    """One decode token: shift the conv window and produce one output.

    x_new: (batch, dim); conv_state: (batch, width, dim), time-major, oldest
    first; weight: (width, dim); bias: (dim,) or None. The new token is
    appended and the oldest dropped. Returns (out (batch, dim) in x_new's
    dtype, float32 math; new_state (batch, width, dim) in conv_state's
    dtype). Functional: conv_state is not changed.
    """
    _check_activation(activation)
    width = weight.shape[0]
    if conv_state.shape[1] != width:
        raise ValueError(f"conv_state {tuple(conv_state.shape)}: window "
                         f"must be {width}")
    new_state = torch.cat([conv_state[:, 1:],
                           x_new[:, None, :].to(conv_state.dtype)], dim=1)
    out = torch.einsum("bwd,wd->bd", new_state.float(), weight.float())
    if bias is not None:
        out = out + bias.float()
    return _activate(out, activation).to(x_new.dtype), new_state
