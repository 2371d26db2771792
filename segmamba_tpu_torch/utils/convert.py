"""Flax param tree -> the port's ``state_dict``.

``flax_to_state_dict`` is the exact inverse of
``segmamba_tpu/utils/torch_convert.py`` ``convert_segmamba_state_dict``
(:83-156); ``encoder_flax_to_state_dict`` and ``mamba_flax_to_state_dict``
do the same for a lone ``MambaEncoder`` (any ``out_indices``) and
``MambaV3`` (with its ``out_proj_bias``); ``lm_flax_to_state_dict`` that of
``segmamba_tpu/utils/hf.py`` ``convert_lm_state_dict`` (:34-69), for the
Mamba language model. The port's module names are the reference torch
model's, so the same names serve both directions. Layout rules undone
here:

- DHWIO (kz, ky, kx, Cin, Cout) conv kernel   -> (Cout, Cin, kz, ky, kx)
- ConvTranspose DHWIO kernel, spatially flipped -> (Cin, Cout, kz, ky, kx)
- (in, out) matmul weight                      -> Linear (out, in)
- depthwise (W, E) filter                      -> Conv1d (E, 1, W)
- LayerNorm scale / bias                       -> weight / bias

Leaves may be numpy arrays or anything ``numpy.asarray`` takes; no flax or
JAX import is needed. ``tp_shard_state_dict`` takes a converted state to a
rank's tensor-parallel shard.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv3d(k):
    return np.transpose(np.asarray(k), (4, 3, 0, 1, 2))


def _conv_transpose3d(k):
    return np.transpose(np.asarray(k)[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


def _linear(w):
    return np.transpose(np.asarray(w), (1, 0))


def _conv1d_depthwise(w):
    return np.transpose(np.asarray(w), (1, 0))[:, None, :]


def _mamba(sd, prefix, p):
    sd[f"{prefix}.in_proj.weight"] = _linear(p["in_proj"])
    sd[f"{prefix}.out_proj.weight"] = _linear(p["out_proj"])
    if "out_proj_bias" in p:   # MambaV3(bias=True)
        sd[f"{prefix}.out_proj.bias"] = np.asarray(p["out_proj_bias"])
    for suf in ("", "_b", "_s"):
        if f"x_proj{suf}" not in p:
            continue
        sd[f"{prefix}.conv1d{suf}.weight"] = _conv1d_depthwise(
            p[f"conv1d{suf}_weight"])
        sd[f"{prefix}.conv1d{suf}.bias"] = np.asarray(p[f"conv1d{suf}_bias"])
        sd[f"{prefix}.x_proj{suf}.weight"] = _linear(p[f"x_proj{suf}"])
        sd[f"{prefix}.dt_proj{suf}.weight"] = _linear(p[f"dt_proj{suf}"])
        sd[f"{prefix}.dt_proj{suf}.bias"] = np.asarray(
            p[f"dt_proj{suf}_bias"])
        sd[f"{prefix}.A{suf}_log"] = np.asarray(p[f"A{suf}_log"])
        sd[f"{prefix}.D{suf}"] = np.asarray(p[f"D{suf}"])


def _res_block(sd, prefix, p):
    for name in ("conv1", "conv2", "conv3"):
        if name in p:
            sd[f"{prefix}.{name}.conv.weight"] = _conv3d(p[name]["kernel"])


def _vit(sd, vit):
    """The encoder (JAX ``MambaEncoder``, the ``vit`` subtree) into ``sd``
    under ``vit.``; a stage's head MlpChannel only where the tree has one
    (the encoder's ``out_indices``)."""
    sd["vit.downsample_layers.0.0.weight"] = _conv3d(vit["stem"]["kernel"])
    sd["vit.downsample_layers.0.0.bias"] = np.asarray(vit["stem"]["bias"])
    for i in range(1, 4):
        ds = vit[f"downsample{i}"]
        sd[f"vit.downsample_layers.{i}.1.weight"] = _conv3d(ds["kernel"])
        sd[f"vit.downsample_layers.{i}.1.bias"] = np.asarray(ds["bias"])
    for i in range(4):
        for name in ("proj", "proj2", "proj3", "proj4"):
            c = vit[f"gsc{i}"][name]
            sd[f"vit.gscs.{i}.{name}.weight"] = _conv3d(c["kernel"])
            sd[f"vit.gscs.{i}.{name}.bias"] = np.asarray(c["bias"])
        j = 0
        while f"stage{i}_block{j}" in vit:
            blk = vit[f"stage{i}_block{j}"]
            pre = f"vit.stages.{i}.{j}"
            sd[f"{pre}.norm.weight"] = np.asarray(blk["LayerNorm_0"]["scale"])
            sd[f"{pre}.norm.bias"] = np.asarray(blk["LayerNorm_0"]["bias"])
            _mamba(sd, f"{pre}.mamba", blk["mamba"])
            j += 1
        for fc in ("fc1", "fc2") if f"mlp{i}" in vit else ():
            c = vit[f"mlp{i}"][fc]
            sd[f"vit.mlps.{i}.{fc}.weight"] = _conv3d(c["kernel"])
            sd[f"vit.mlps.{i}.{fc}.bias"] = np.asarray(c["bias"])


def _tensors(sd):
    # copies: leaves may be read-only views of the caller's arrays
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def encoder_flax_to_state_dict(vit):
    """JAX ``MambaEncoder`` params (numpy leaves) -> the port's
    ``MambaEncoder`` ``state_dict`` (float32 CPU tensors)."""
    sd = {}
    _vit(sd, vit)
    return _tensors({k[len("vit."):]: v for k, v in sd.items()})


def mamba_flax_to_state_dict(params):
    """JAX ``MambaV3`` params (numpy leaves) -> the port's ``MambaV3``
    ``state_dict`` (float32 CPU tensors; ``out_proj.bias`` where the tree
    has ``out_proj_bias``, i.e. ``bias=True``)."""
    p = params["params"] if "params" in params else params
    sd = {}
    _mamba(sd, "m", p)
    return _tensors({k[len("m."):]: v for k, v in sd.items()})


def flax_to_state_dict(params):
    """JAX ``{"params": ...}`` tree (numpy leaves) -> the port's
    ``state_dict`` (float32 CPU tensors, reference torch names)."""
    p = params["params"] if "params" in params else params
    sd = {}
    _vit(sd, p["vit"])
    for k in range(1, 6):
        _res_block(sd, f"encoder{k}.layer", p[f"encoder{k}"]["layer"])
    for k in range(2, 6):
        dec = p[f"decoder{k}"]
        sd[f"decoder{k}.transp_conv.conv.weight"] = _conv_transpose3d(
            dec["transp_conv"]["kernel"])
        _res_block(sd, f"decoder{k}.conv_block", dec["conv_block"])
    _res_block(sd, "decoder1.layer", p["decoder1"]["layer"])
    sd["out.conv.conv.weight"] = _conv3d(p["out"]["conv"]["kernel"])
    sd["out.conv.conv.bias"] = np.asarray(p["out"]["conv"]["bias"])
    return _tensors(sd)


def lm_flax_to_state_dict(params):
    """JAX ``MambaLMHeadModel`` ``{"params": ...}`` tree (numpy leaves) ->
    the port's ``MambaLMHeadModel`` ``state_dict`` (float32 CPU tensors,
    reference torch names, no ``lm_head.weight``: the head is tied)."""
    p = params["params"] if "params" in params else params
    bb = p["backbone"]
    sd = {"backbone.embedding.weight": np.asarray(bb["embedding"])}
    i = 0
    while f"layers_{i}" in bb:
        layer, pre = bb[f"layers_{i}"], f"backbone.layers.{i}"
        m = layer["mixer"]
        sd[f"{pre}.mixer.in_proj.weight"] = _linear(m["in_proj"])
        sd[f"{pre}.mixer.conv1d.weight"] = _conv1d_depthwise(
            m["conv1d_weight"])
        sd[f"{pre}.mixer.conv1d.bias"] = np.asarray(m["conv1d_bias"])
        sd[f"{pre}.mixer.x_proj.weight"] = _linear(m["x_proj"])
        sd[f"{pre}.mixer.dt_proj.weight"] = _linear(m["dt_proj"])
        sd[f"{pre}.mixer.dt_proj.bias"] = np.asarray(m["dt_proj_bias"])
        sd[f"{pre}.mixer.A_log"] = np.asarray(m["A_log"])
        sd[f"{pre}.mixer.D"] = np.asarray(m["D"])
        sd[f"{pre}.mixer.out_proj.weight"] = _linear(m["out_proj"])
        sd[f"{pre}.norm.weight"] = np.asarray(layer["norm_weight"])
        if "norm_bias" in layer:
            sd[f"{pre}.norm.bias"] = np.asarray(layer["norm_bias"])
        i += 1
    sd["backbone.norm_f.weight"] = np.asarray(bb["norm_f_weight"])
    if "norm_f_bias" in bb:
        sd["backbone.norm_f.bias"] = np.asarray(bb["norm_f_bias"])
    return _tensors(sd)


def load_flax_params(model, params):
    """Load a JAX param tree into the port's ``SegMamba`` (strict)."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def tp_shard_state_dict(sd, index, n):
    """Rank ``index``'s tensor-parallel shard (of ``n``) of a converted
    ``state_dict``: the Mamba-inner tensors cut by ``parallel.tp``'s rules
    (in_proj per half), the rest whole. ``parallel.tp.tp_gather_state``
    undoes it, so a sharded state saves as the whole tree."""
    from segmamba_tpu_torch.parallel.tp import shard_tensor, tp_specs

    specs = tp_specs(sd, n)
    return {k: shard_tensor(v, specs[k], index, n).clone()
            for k, v in sd.items()}
