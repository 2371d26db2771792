"""Differentiable collectives of the sequence- and tensor-parallel paths.

In JAX, ``shard_map`` and GSPMD derive these from the sharding specs
(``segmamba_tpu/ops/scan_sharded.py``, ``parallel/tp.py``); here each is a
``torch.autograd.Function`` whose backward is chosen for how its output is
used. Every one is written on ``all_gather`` and ``all_reduce`` alone, which
NCCL and gloo both take on CUDA tensors, so one code path serves both
backends. Floating tensors of two bytes cross a gather as their bytes
(exact, whatever dtypes the backend takes); sums run in float32.

A collective in a backward runs only where autograd reaches the op, so
each op's output must be used on every rank of its group, or every rank's
backward stops short of the collective alike. (The scan's entry-state
gather, whose output the first shard in scan order does not use, is one
op with its prefix in ``ops/scan_sharded.py`` for that reason.)

Outside a sharded region the ranks of a group compute the same thing (a
replicated activation). Then:

- ``shard(x, dim, group)`` takes this rank's contiguous share along
  ``dim``. Its backward all-gathers the shares' gradients: each rank's
  copy of the replicated input gets the whole gradient (a sum would count
  it once per rank).
- ``unshard(x, dim, group)`` all-gathers the shares into the replicated
  tensor. Its backward keeps this rank's slice of the (replicated)
  gradient and does not sum: ``torch.distributed.nn.all_gather`` sums,
  which gives ``n`` times the gradient here.
- ``halo(tail, group, reverse)`` hands each rank the tail of its
  scan-order predecessor (rank i - 1, or i + 1 with ``reverse``; zeros at
  the first): JAX's ``ppermute``. The backward sends the halo's gradient
  back to the predecessor.
- ``sum_grads(group, *tensors)`` is the identity, and all-reduces (sums)
  the tensors' gradients: parameters used inside a sharded region, whose
  per-rank gradients are partial; and, for tensor parallelism, the
  replicated input of a column-parallel product (Megatron's "f").
- ``sum_shares(x, group, grad_sum)`` all-reduces (sums) partial products:
  with ``grad_sum=False`` after ``out_proj``, whose sum every rank then
  uses alike (Megatron's "g": the backward is the identity); with
  ``grad_sum=True`` for ``x_proj``'s partial sums, whose sum each rank
  uses for its own channels (the backward sums the ranks' gradients too).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group):
    return dist.get_world_size(group)


def _index(group):
    return dist.get_rank(group)


def _bits(x):
    """Two-byte floats as bytes (uint8, the last axis doubled), so a gather
    moves bits, not values: NCCL and gloo both take uint8 (neither takes
    int16, and gloo on CUDA tensors takes no bfloat16)."""
    return x.view(torch.uint8) if x.element_size() == 2 and \
        x.is_floating_point() else x


def _all_gather(x, group):
    """List of every rank's ``x`` (same shape and dtype), in rank order."""
    x = x.contiguous()
    send = _bits(x)
    parts = [torch.empty_like(send) for _ in range(_size(group))]
    dist.all_gather(parts, send, group=group)
    return [p.view(x.dtype) for p in parts] if send is not x else parts


def _all_reduce_f32(x, group):
    """Sum of every rank's ``x``, added in float32, in x's dtype."""
    y = x.float().contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = _size(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over {n} ranks")
        return x.chunk(n, dim)[_index(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.group), ctx.dim), None, None


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        n = _size(ctx.group)
        return g.chunk(n, ctx.dim)[_index(ctx.group)].contiguous(), None, None


def _predecessor(group, reverse):
    """(scan-order predecessor's index or None, successor's or None)."""
    i, n = _index(group), _size(group)
    step = 1 if reverse else -1
    pred, succ = i + step, i - step
    return (pred if 0 <= pred < n else None,
            succ if 0 <= succ < n else None)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tail, group, reverse):
        ctx.group, ctx.reverse = group, reverse
        pred, _ = _predecessor(group, reverse)
        tails = _all_gather(tail, group)
        return torch.zeros_like(tail) if pred is None else tails[pred]

    @staticmethod
    def backward(ctx, g):
        _, succ = _predecessor(ctx.group, ctx.reverse)
        grads = _all_gather(g, ctx.group)
        return (torch.zeros_like(g) if succ is None else grads[succ],
                None, None)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        if live:
            flat = torch.cat([g.float().reshape(-1) for g in live])
            dist.all_reduce(flat, group=ctx.group)
            parts = iter(flat.split([g.numel() for g in live]))
            gs = tuple(None if g is None else next(parts).view_as(g).to(
                g.dtype) for g in gs)
        return (None,) + gs


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce_f32(g, ctx.group) if ctx.grad_sum else g,
                None, None)


def shard(x, dim, group):
    return _Shard.apply(x, dim, group)


def unshard(x, dim, group):
    return _Unshard.apply(x, dim, group)


def halo(tail, group, reverse=False):
    return _Halo.apply(tail, group, reverse)


def sum_grads(group, *tensors):
    """``tensors`` unchanged (a tuple), their gradients summed over
    ``group``."""
    return _SumGrads.apply(group, *tensors)


def sum_shares(x, group, grad_sum):
    return _SumShares.apply(x, group, grad_sum)
