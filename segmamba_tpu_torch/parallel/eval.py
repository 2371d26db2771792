"""Distributed evaluation helpers.

Port of ``segmamba_tpu/parallel/eval.py`` (``sequential_shards``,
``distributed_concat``, ``eval_map``), the reference's
``SequentialDistributedSampler`` (contiguous shards, the case list padded by
wrap-around to a multiple of the ranks) and ``distributed_concat`` (gather,
drop the padding). JAX drives one thread per local device; here each data
rank evaluates its own shard and the results meet by
``all_gather_object``.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist


def sequential_shards(n_items, n_shards):
    """Contiguous per-shard index lists, padded (by wrap-around repetition)
    to equal length; (shards, keep_mask) where mask marks real items."""
    per = -(-n_items // n_shards)
    idx = list(range(n_items))
    padded = idx + idx[: per * n_shards - n_items]
    shards, mask = [], []
    for s in range(n_shards):
        chunk = padded[s * per:(s + 1) * per]
        shards.append(chunk)
        mask.append([s * per + i < n_items for i in range(per)])
    return shards, mask


def distributed_concat(per_shard_results, n_total):
    """Concatenate shard-ordered results and drop padding
    (sampler.py:44-48 semantics)."""
    flat = np.concatenate([np.asarray(r) for r in per_shard_results], axis=0)
    return flat[:n_total]


def gather_shard_results(own, mask, group):
    """Every data rank's results of its shard (``own``, in shard order),
    in item order, the wrap-around padding (``mask``, this rank's keep
    mask) dropped; every rank of ``group`` gets the whole list."""
    kept = [r for r, keep in zip(own, mask) if keep]
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, kept, group=group)
    return [r for part in parts for r in part]


def eval_map(fn, items, mesh=None):
    """Run ``fn`` over ``items`` sharded over ``mesh``'s "data" axis like
    SequentialDistributedSampler: each data rank evaluates its contiguous
    shard (the other axes' ranks of its coordinate evaluate the same
    items, as a sequence- or tensor-parallel model needs), and every rank
    returns all results in item order, the padding dropped. Without a
    data axis, ``fn`` over all items."""
    if mesh is None or "data" not in mesh.axis_names:
        return [fn(x) for x in items]
    shards, mask = sequential_shards(len(items), mesh.size("data"))
    i = mesh.index("data")
    own = [fn(items[k]) for k in shards[i]]
    return gather_shard_results(own, mask[i], mesh.group("data"))
