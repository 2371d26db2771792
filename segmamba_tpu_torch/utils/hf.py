"""Pretrained Mamba LM loading from a local snapshot directory.

Port of ``segmamba_tpu/utils/hf.py`` (``load_config``,
``convert_lm_state_dict``, ``from_pretrained``): the loaders read the files
a ``state-spaces/mamba-*`` snapshot holds (``config.json`` and
``pytorch_model.bin`` or ``model.pt``) from a local directory; nothing is
fetched. The port's names are the reference's, so the conversion only
strips a ``module.`` prefix and drops the tied ``lm_head.weight``.

As in the JAX loader, the embedding (and the tied head) take the
checkpoint's own ``backbone.embedding.weight`` rows, so a snapshot whose
vocabulary was padded to ``pad_vocab_size_multiple`` (50277 -> 50280) and
one saved with the raw ``vocab_size`` rows both load strictly; the logits
have the checkpoint's width. ``rms_norm`` defaults to True when the config
omits it, as in JAX (the model class's own default is False).
"""

from __future__ import annotations

import json
import os

import torch

from segmamba_tpu_torch.models.mamba_lm import MambaLMHeadModel

WEIGHT_FILES = ("pytorch_model.bin", "model.pt")


def load_config(model_dir: str) -> dict:
    """Read ``config.json`` (d_model, n_layer, vocab_size, rms_norm, ...)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def convert_lm_state_dict(state_dict) -> dict:
    """Reference ``MambaLMHeadModel.state_dict()`` -> the port's: strip a
    ``module.`` prefix, drop the tied ``lm_head.weight``."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    sd.pop("lm_head.weight", None)
    return sd


def from_pretrained(model_dir: str, dtype=torch.float32, device="cuda",
                    scan_impl: str = "auto") -> MambaLMHeadModel:
    """Build a ``MambaLMHeadModel`` from a local snapshot directory and load
    its weights strictly. ``dtype`` is the compute dtype (parameters stay
    float32); the model is moved to ``device`` (a CUDA card unless the
    caller asks for the CPU)."""
    cfg = load_config(model_dir)
    path = next((os.path.join(model_dir, n) for n in WEIGHT_FILES
                 if os.path.exists(os.path.join(model_dir, n))), None)
    if path is None:
        raise FileNotFoundError(f"no weights file ({', '.join(WEIGHT_FILES)})"
                                f" in {model_dir}")
    sd = convert_lm_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))
    vocab_rows = sd["backbone.embedding.weight"].shape[0]
    model = MambaLMHeadModel(
        vocab_rows, cfg["d_model"], cfg["n_layer"],
        rms_norm=cfg.get("rms_norm", True), scan_impl=scan_impl,
        dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(device)
