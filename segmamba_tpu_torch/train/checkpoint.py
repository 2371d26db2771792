"""Checkpoints: the full train state with keep-best metric-named files.

Port of ``segmamba_tpu/train/checkpoint.py`` with ``torch.save`` in place of
orbax. A checkpoint holds the model's ``state_dict``, the optimizer's
(momentum), the update count, the epoch and the metric, so a run can
resume. Names keep the reference layout: ``<symbol>_<metric:.4f>.pt``
(``best_model_0.8123.pt``, ``final_model_...``) with exactly one file per
symbol (``save_new_and_delete_last``), plus ``tmp_model_ep{e}_{m:.4f}.pt``
every 100 epochs. Reading a JAX orbax checkpoint is not supported.

``load_model_weights`` loads the model's weights alone for inference, from
such a checkpoint or from a reference-format ``state_dict`` (the port's
parameter names are the reference model's).
"""

from __future__ import annotations

import glob
import math
import os

import torch
import torch.distributed as dist

from segmamba_tpu_torch.parallel.mesh import broadcast_tree
from segmamba_tpu_torch.parallel.multihost import is_main_process


def save_checkpoint(state, path, epoch=0, metric=None):
    """Write the full state to ``path`` (through a temporary file, so a
    crash never leaves half a checkpoint under the final name). Across
    ranks every rank calls it (a tensor-parallel state is gathered whole)
    and the main process writes."""
    model_sd, opt_sd = state.whole_state()
    path = os.path.abspath(path)
    if not is_main_process():
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({
        "model": model_sd,
        "optimizer": opt_sd,
        "step": int(state.step),
        "epoch": int(epoch),
        "metric": float(metric) if metric is not None else math.nan,
    }, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(state, path):
    """Load a checkpoint written by ``save_checkpoint`` into ``state``;
    returns (state, epoch). Across ranks (a ``state`` on a mesh) every
    rank calls it: rank 0 reads ``path`` and broadcasts what it read, so
    the other ranks need no access to the file."""
    device = next(state.model.parameters()).device
    if state.mesh is None:
        ck = torch.load(path, map_location=device, weights_only=True)
    else:
        ck = (torch.load(path, map_location=device, weights_only=True)
              if dist.get_rank() == 0 else None)
        ck = broadcast_tree(ck, 0, device=device)
    state.load_whole_state(ck["model"], ck["optimizer"])
    state.step = int(ck["step"])
    return state, int(ck["epoch"])


def save_new_and_delete_last(state, model_dir, symbol, metric, epoch):
    """Keep exactly one ``<symbol>_<metric:.4f>.pt`` per symbol (files
    written and removed by the main process)."""
    new_path = os.path.join(model_dir, f"{symbol}_{metric:.4f}.pt")
    if is_main_process():
        os.makedirs(model_dir, exist_ok=True)
    old = [p for p in glob.glob(os.path.join(model_dir, f"{symbol}_*.pt"))
           if os.path.abspath(p) != os.path.abspath(new_path)]
    save_checkpoint(state, new_path, epoch=epoch, metric=metric)
    if not is_main_process():
        return new_path
    for p in old:
        os.remove(p)
    return new_path


def find_checkpoint(model_dir, symbol="best_model"):
    """The (single) checkpoint of a symbol; else any checkpoint; else
    None."""
    cands = sorted(glob.glob(os.path.join(model_dir, f"{symbol}_*.pt")))
    if not cands:
        cands = sorted(glob.glob(os.path.join(model_dir, "*_*.pt")))
    return cands[-1] if cands else None


def load_model_weights(model, path):
    """Load the weights at ``path`` into ``model`` (strictly) and return it.

    ``path`` holds a checkpoint of ``save_checkpoint`` (its ``"model"``
    entry) or a reference torch ``state_dict``, bare or under a
    ``"state_dict"`` key, as JAX's ``load_torch_checkpoint`` takes it; a
    DDP ``module.`` prefix is stripped and BatchNorm's
    ``num_batches_tracked`` counters are dropped."""
    device = next(model.parameters()).device
    sd = torch.load(path, map_location=device, weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
            break
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)
    return model
