"""The port's ``config.py`` and LM snapshot loading vs the JAX package, on
the CPU.

- A JSON file written by the JAX ``Config.to_json`` loads unchanged into
  the port's ``Config`` (the same fields and values), both write the same
  JSON for the defaults, and ``build_model(device="cpu")`` builds the
  port's SegMamba with the config's width, ``scan_impl``, ``remat`` and
  compute dtype.
- An LM snapshot saved with the raw ``vocab_size`` embedding rows (as
  tests/test_hf_loading.py writes one: vocab 50, no padding) loads in the
  port as it does in JAX: the embedding and the logits take the
  checkpoint's 50 rows and the logits equal the saved model's exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from segmamba_tpu.config import Config as JConfig
from segmamba_tpu.config import ModelConfig as JModelConfig
from segmamba_tpu.config import TrainConfig as JTrainConfig
from segmamba_tpu.utils.hf import from_pretrained as j_from_pretrained
from segmamba_tpu_torch.config import Config, ModelConfig
from segmamba_tpu_torch.models import MambaLMHeadModel
from segmamba_tpu_torch.utils.hf import from_pretrained

TINY = dict(in_chans=2, out_chans=3, depths=[1, 1, 1, 1],
            feat_size=[4, 8, 16, 32], hidden_size=64,
            num_slices_list=[8, 8, 4, 4])


def test_config_loads_jax_json(tmp_path):
    path = tmp_path / "cfg.json"
    JConfig(model=JModelConfig(scan_impl="proj", remat=True,
                               dtype="float32", **TINY),
            train=JTrainConfig(batch_size=3, patch_size=(96, 96, 96))
            ).to_json(str(path))
    cfg = Config.from_json(str(path))
    want = json.loads(path.read_text())
    assert json.loads(cfg.to_json()) == want
    assert cfg.model.scan_impl == "proj" and cfg.train.batch_size == 3
    assert Config.from_json(path.read_text()) == cfg
    assert Config().to_json() == JConfig().to_json()
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(JModelConfig)]


@pytest.mark.parametrize("scan_impl,remat,dtype", [
    ("proj", "convs", "bfloat16"), ("auto", False, "float32")])
def test_build_model(scan_impl, remat, dtype):
    cfg = Config(model=ModelConfig(scan_impl=scan_impl, remat=remat,
                                   dtype=dtype, **TINY))
    model = cfg.build_model(device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert model.remat == remat
    assert model.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[dtype]
    mixers = [layer.mamba for stage in model.vit.stages for layer in stage]
    assert [m.scan_impl for m in mixers] == [scan_impl] * 4
    assert [m.nslices for m in mixers] == TINY["num_slices_list"]
    assert next(model.parameters()).device.type == "cpu"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 2, 32, 32, 32)).astype(np.float32))
    with torch.no_grad():
        y = model(x)
    assert y.shape == (1, 3, 32, 32, 32) and torch.isfinite(y).all()
    with pytest.raises(ValueError, match="dtype"):
        Config(model=ModelConfig(dtype="float16")).build_model(device="cpu")


def test_unpadded_lm_snapshot_loads_as_in_jax(tmp_path):
    src = MambaLMHeadModel(50, 16, 2, rms_norm=True,
                           generator=torch.Generator().manual_seed(4))
    assert src.backbone.embedding.weight.shape == (50, 16)
    (tmp_path / "config.json").write_text(json.dumps(
        dict(d_model=16, n_layer=2, vocab_size=50, rms_norm=True)))
    sd = dict(src.state_dict())
    sd["lm_head.weight"] = src.backbone.embedding.weight.detach().clone()
    torch.save(sd, tmp_path / "pytorch_model.bin")
    model = from_pretrained(str(tmp_path), device="cpu")
    _, params = j_from_pretrained(str(tmp_path))
    emb = params["params"]["backbone"]["embedding"]
    assert model.backbone.embedding.weight.shape == emb.shape == (50, 16)
    assert model.vocab_size == 50
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 50, (1, 7)))
    with torch.no_grad():
        out = model(ids)
        assert out.shape == (1, 7, 50)
        assert torch.equal(out, src(ids))
