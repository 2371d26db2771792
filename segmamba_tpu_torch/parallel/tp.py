"""Tensor parallelism: channel shards of the Mamba inner parameters.

Port of ``segmamba_tpu/parallel/tp.py`` (``tp_specs``, ``tp_shard``). The
selective scan is elementwise over the inner channels (d_inner), so a
``MambaV3``'s inner parameters split over a "model" axis. JAX places them
with NamedShardings and GSPMD inserts the reductions; here each rank keeps
its slice of the same name-keyed rule table (``tp.py:40-56``), in torch's
layouts (a Linear weight is (out, in)), and ``MambaV3`` reduces the two
row-parallel products itself (``parallel.comm``):

    in_proj.weight      (2 E, d_model)  rows, per half   (JAX P(None, m))
    conv1d*.weight      (E, 1, W)       rows             (P(None, m))
    conv1d*.bias        (E,)                             (P(m))
    x_proj*.weight      (R + 2N, E)     columns          (P(m, None))
    dt_proj*.weight     (E, R)          rows             (P(None, m))
    dt_proj*.bias       (E,)                             (P(m))
    A*_log              (E, N)          rows             (P(m, None))
    D*                  (E,)                             (P(m))
    out_proj.weight     (d_model, E)    columns          (P(m, None))

``in_proj`` holds x and z side by side; a contiguous split of its 2 E rows
would give rank 0 all of x and rank 1 all of z, so each half splits apart
and a rank keeps its channels of both. Everything else (the encoder and
decoder convs, norms, heads, ``out_proj.bias``) stays whole on every rank,
and so does a layer whose d_inner the model axis does not divide (it runs
unsharded, as JAX's ``MambaV3`` does). Momentum buffers follow their
parameters: a state dict's ``momentum_buffer`` entries take the same rule.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch
import torch.distributed as dist


class Shard(NamedTuple):
    """Split dimension ``dim`` of a tensor; ``halves``: split each half of
    that dimension apart (in_proj's x and z)."""
    dim: int
    halves: bool = False


_RULES = (
    (r"in_proj\.weight", Shard(0, True)),
    (r"conv1d(_b|_s)?\.(weight|bias)", Shard(0)),
    (r"x_proj(_b|_s)?\.weight", Shard(1)),
    (r"dt_proj(_b|_s)?\.(weight|bias)", Shard(0)),
    (r"A(_b|_s)?_log", Shard(0)),
    (r"D(_b|_s)?", Shard(0)),
    (r"out_proj\.weight", Shard(1)),
)


def _leaf_spec(name: str):
    """The rule for a parameter's last name parts, or None (replicated)."""
    for pattern, spec in _RULES:
        if re.fullmatch(r"(.*\.)?" + pattern, name):
            return spec
    return None


def _owner(name):
    """``a.b.mamba.x_proj_b.weight`` -> ``a.b.mamba``: the MambaV3 prefix."""
    for pattern, _ in _RULES:
        m = re.fullmatch(r"(.*\.)?" + pattern, name)
        if m:
            return (m.group(1) or "").rstrip(".")
    return None


def tp_specs(state, n_model):
    """{name: Shard or None} for a ``state_dict``-like mapping of names to
    tensors (a model's parameters) over ``n_model`` ranks: a layer whose
    d_inner (from its ``in_proj.weight``) does not divide over them stays
    whole."""
    specs = {name: _leaf_spec(name) for name in state}
    for name, spec in specs.items():
        if spec is None:
            continue
        in_proj = state.get(_join(_owner(name), "in_proj.weight"))
        if in_proj is None or (in_proj.shape[0] // 2) % n_model:
            specs[name] = None
    return specs


def _join(prefix, leaf):
    return f"{prefix}.{leaf}" if prefix else leaf


def shard_tensor(t, spec, index, n):
    """This rank's (``index`` of ``n``) slice of ``t`` under ``spec``."""
    if spec is None:
        return t
    if spec.halves:
        return torch.cat([h.chunk(n, spec.dim)[index]
                          for h in t.chunk(2, spec.dim)], spec.dim)
    return t.chunk(n, spec.dim)[index]


def gather_tensor(t, spec, group):
    """The whole tensor from every rank's shard under ``spec``."""
    if spec is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    if spec.halves:
        halves = [p.chunk(2, spec.dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         spec.dim)
    return torch.cat(parts, spec.dim)


def tp_shard(model, mesh, model_axis: str = "model"):
    """Keep this rank's channel slice of ``model``'s Mamba-inner
    parameters over ``mesh``'s ``model_axis`` (in place); returns the set
    of sharded parameter names. Call it before the optimizer is built, so
    its momentum is made at the shards' shapes."""
    n, i = mesh.size(model_axis), mesh.index(model_axis)
    params = dict(model.named_parameters())
    specs = tp_specs(params, n)
    with torch.no_grad():
        for name, spec in specs.items():
            if spec is not None:
                p = params[name]
                p.data = shard_tensor(p.data, spec, i, n).clone()
    return {name for name, spec in specs.items() if spec is not None}


def tp_gather_state(state, mesh, sharded, model_axis: str = "model"):
    """The whole tensors of a name -> tensor mapping (a model's
    ``state_dict``, or momentum buffers under their parameters' names)
    whose names in ``sharded`` (``tp_shard``'s result) hold this rank's
    shard: gathered over the model axis (every rank calls it)."""
    group = mesh.group(model_axis)
    return {k: gather_tensor(v, _leaf_spec(k) if k in sharded else None,
                             group) for k, v in state.items()}
