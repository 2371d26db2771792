"""Sequence-parallel selective scan and Mamba inner op over a process group.

Port of ``segmamba_tpu/ops/scan_sharded.py`` (``causal_conv1d_sharded_local``,
``_entry_state``, ``selective_scan_sharded``, ``mamba_inner_sharded``). The
JAX functions take global arrays and a mesh and run their body under
``shard_map``; these take the body's view: this rank's token shard of the
sequences and the ``group`` of the sequence ranks (rank i of the group
holds tokens [i L_loc, (i + 1) L_loc)). Each rank scans its shard, and the
state entering it comes from one small gather, exact because a shard's
decay has the closed form ``prod_t exp(delta_t A) = exp(A sum_t delta_t)``:

  1. local scan with zero initial state -> y_loc, last_loc: the K6 core
     (``scan_core``; the kernel for CUDA tensors, its plain version for
     CPU ones), JAX's ``selective_scan_pallas(return_last_state=True)``;
  2. decay = exp(A * sum_t delta_t)               (batch, dim, N)
  3. entry = exclusive prefix of the gathered (decay, last) pairs over
     scan order (a static loop over the group's ranks)
  4. y += C_t . (exp(A * cumsum(delta)_t) * entry)  (``fixup``)
  5. D skip and silu(z) gate.

The fix-up never holds the (batch, L, dim, N) tensor of step 4 whole:
``_FixUp`` computes it, forward and backward, over chunks of tokens and
recomputes the exponentials in the backward.

The depthwise causal conv crosses shard boundaries with a (width - 1)-token
halo from the scan-order predecessor (``parallel.comm.halo``). With
``reverse=True`` the inner op runs right to left (the bimamba flip
orientation): each rank flips its shard locally, the predecessor is rank
i + 1 and the first shard in scan order is the last rank's.

Gradients: the collectives' backwards are in ``parallel/comm.py``.
Parameters are used whole on every rank, so their gradients here are this
shard's part; the caller sums them over the group (``MambaV3`` does, with
``comm.sum_grads``).
"""

from __future__ import annotations

import torch

from segmamba_tpu_torch.ops import scan_core
from segmamba_tpu_torch.ops.causal_conv1d import causal_conv1d
from segmamba_tpu_torch.ops.mamba_inner import projections
from segmamba_tpu_torch.ops.selective_scan import (
    _postprocess,
    _preprocess_delta,
)
from segmamba_tpu_torch.parallel import comm

# elements of one (batch, chunk, dim, N) float32 temporary of the fix-up
FIXUP_ELEMS = 1 << 24


def causal_conv1d_sharded_local(x, weight, bias, group, activation=None,
                                reverse=False):
    """Per-shard causal conv with a halo from the scan-order predecessor.
    x: this rank's (batch, L_loc, dim), already in local scan order; L_loc
    >= width - 1."""
    width = weight.shape[0]
    h = comm.halo(x[:, x.shape[1] - (width - 1):], group, reverse)
    y = causal_conv1d(torch.cat([h, x], dim=1), weight, bias,
                      activation=activation)
    return y[:, width - 1:]


def _prefix(pairs, idx):
    """Exclusive prefix at scan position ``idx`` of the gathered (decay,
    last) pairs (n, 2, ...), in scan order."""
    entry = torch.zeros_like(pairs[0, 1])
    for j in range(idx):
        entry = pairs[j, 0] * entry + pairs[j, 1]
    return entry


class _EntryState(torch.autograd.Function):
    """JAX's ``all_gather`` of the (decay, last) pairs and the prefix over
    them, as one op: the backward differentiates this rank's prefix with
    respect to every rank's pair, sums those over the group and keeps this
    rank's (a reduce-scatter written as an all-reduce and a slice). One
    op, so that the first shard in scan order, whose entry is zero, still
    takes part in the backward's collective."""

    @staticmethod
    def forward(ctx, decay, last, group, reverse):
        pairs = torch.stack(comm._all_gather(torch.stack([decay, last]),
                                             group))
        n, rank = pairs.shape[0], torch.distributed.get_rank(group)
        ctx.group, ctx.rank = group, rank
        ctx.idx = n - 1 - rank if reverse else rank
        ctx.reverse = reverse
        ctx.save_for_backward(pairs)
        return _prefix(pairs.flip(0) if reverse else pairs, ctx.idx)

    @staticmethod
    def backward(ctx, dentry):
        pairs, = ctx.saved_tensors
        dp = torch.zeros_like(pairs)
        if ctx.idx:    # the first shard's entry is zero: no pair reaches it
            with torch.enable_grad():
                p = pairs.detach().requires_grad_()
                entry = _prefix(p.flip(0) if ctx.reverse else p, ctx.idx)
                dp, = torch.autograd.grad(entry, p, dentry)
        dp = comm._all_reduce_f32(dp, ctx.group)[ctx.rank]
        return dp[0], dp[1], None, None


def _entry_state(decay, last_loc, group, reverse=False):
    """This shard's entry state from every shard's (decay, last) pair:
    ``entry_i = sum_{j<i} (prod_{j<k<i} decay_k) last_j`` over scan order,
    i.e. the exclusive prefix of ``e_i = decay_{i-1} e_{i-1} + last_{i-1}``
    (a static loop over the group's ranks). With ``reverse=True`` scan
    position is ``n - 1 - rank``."""
    return _EntryState.apply(decay, last_loc, group, reverse)


def _fixup_chunks(L, b, dim, N):
    step = max(1, FIXUP_ELEMS // max(1, b * dim * N))
    return [(s, min(L, s + step)) for s in range(0, L, step)]


class _FixUp(torch.autograd.Function):
    """y_t = C_t . (exp(A cd_t) * entry) over (batch, L, dim, N) without
    holding that tensor: C (b, L, N), cd (b, L, dim) the inclusive cumsum
    of delta, A (dim, N), entry (b, dim, N), all float32."""

    @staticmethod
    def forward(ctx, C, cd, A, entry):
        b, L, dim = cd.shape
        y = cd.new_empty(b, L, dim)
        for s, e in _fixup_chunks(L, b, dim, A.shape[-1]):
            w = torch.exp(cd[:, s:e, :, None] * A) * entry[:, None]
            y[:, s:e] = torch.einsum("bln,bldn->bld", C[:, s:e], w)
        ctx.save_for_backward(C, cd, A, entry)
        return y

    @staticmethod
    def backward(ctx, dy):
        C, cd, A, entry = ctx.saved_tensors
        b, L, dim = cd.shape
        dC, dcd = torch.empty_like(C), torch.empty_like(cd)
        dA, dentry = torch.zeros_like(A), torch.zeros_like(entry)
        dy = dy.float()
        for s, e in _fixup_chunks(L, b, dim, A.shape[-1]):
            cds = cd[:, s:e, :, None]
            E = torch.exp(cds * A)                           # (b, l, d, N)
            # dL/dw, w = E * entry: dy_t C_t, per channel and state
            dw = dy[:, s:e, :, None] * C[:, s:e, None, :]
            dC[:, s:e] = torch.einsum("bld,bldn->bln", dy[:, s:e],
                                      E * entry[:, None])
            dentry += (dw * E).sum(1)
            dE = dw * entry[:, None] * E                     # dL/d(A cd)
            dcd[:, s:e] = (dE * A).sum(-1)
            dA += (dE * cds).sum((0, 1))
        return dC, dcd, dA, dentry


def fixup(C, cd, A, entry):
    """``einsum("bln,bldn->bld", C, exp(cd[..., None] * A) * entry[:,
    None])`` in token chunks, differentiable (``_FixUp``)."""
    return _FixUp.apply(C.float(), cd.float(), A.float(), entry.float())


def fixup_ref(C, cd, A, entry):
    """The plain 4-D form of ``fixup`` (test oracle)."""
    return torch.einsum("bln,bldn->bld", C,
                        torch.exp(cd[..., None] * A) * entry[:, None])


def _scan_shard(u, d, A, B, C, group, reverse, chunk_size):
    """Steps 1-4 on float32 operands of this shard: y before D and gate."""
    y_loc, last_loc = scan_core._core(u, d, A, B, C, chunk_size)
    decay = torch.exp(d.sum(1)[..., None] * A)               # (b, dim, N)
    entry = _entry_state(decay, last_loc, group, reverse=reverse)
    return y_loc + fixup(C, torch.cumsum(d, 1), A, entry)


def selective_scan_sharded(u, delta, A, B, C, D=None, z=None,
                           delta_bias=None, delta_softplus=False, *, group,
                           chunk_size=scan_core.DEF_CHUNK):
    """Selective scan of a sequence sharded over ``group``: ``u, delta, z``
    (batch, L_loc, dim) and time-varying ``B, C`` (batch, L_loc, N) are
    this rank's tokens, ``A`` (dim, N), ``D`` and ``delta_bias`` (dim,)
    whole on every rank. Returns this rank's (batch, L_loc, dim) in
    u.dtype; exact up to float32 rounding against the unsharded scan."""
    d = _preprocess_delta(delta, delta_bias, delta_softplus)
    y = _scan_shard(u.float(), d, A.float(), B.float(), C.float(), group,
                    False, chunk_size)
    return _postprocess(y, u, D, z, u.dtype)


def mamba_inner_sharded(xz, conv_weight, conv_bias, x_proj, dt_proj,
                        dt_bias, A, D_skip, *, d_state, group,
                        chunk_size=scan_core.DEF_CHUNK, reverse=False):
    """Sequence-parallel ``mamba_inner``: ``xz`` (batch, L_loc, 2 d_inner)
    is this rank's token shard, the weights (the JAX layout, as
    ``mamba_inner``) whole. ``reverse=True`` runs the op right to left
    with inputs and output in the original token order; only the halo and
    the carry change direction. Returns this rank's (batch, L_loc,
    d_inner) in xz.dtype, gated, before out_proj."""
    d_inner = xz.shape[-1] // 2
    x, z = xz[..., :d_inner], xz[..., d_inner:]
    if reverse:
        x, z = x.flip(1), z.flip(1)
    x = causal_conv1d_sharded_local(x, conv_weight, conv_bias, group,
                                    activation="silu", reverse=reverse)
    dt, Bm, Cm = projections(x, x_proj, dt_proj, d_state)
    d = _preprocess_delta(dt, dt_bias, True)
    y = _scan_shard(x.float(), d, A.float(), Bm.float(), Cm.float(), group,
                    reverse, chunk_size)
    out = _postprocess(y, x, D_skip, z, xz.dtype)
    return out.flip(1) if reverse else out
