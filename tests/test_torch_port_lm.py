"""The port's Mamba language model vs the JAX package, on the CPU.

A tiny LM (vocab 64, d_model 32, n_layer 2, d_state 16) is initialised in
JAX and its weights are bridged into the port by ``lm_flax_to_state_dict``.
Both sides then see the same numpy-seeded token ids: logits of the full
forward, the prefill's hidden states and decode caches, the logits of each
decode ``step``, and the tokens of greedy ``generate`` (which must be equal).
Float32 throughout, rtol 1e-4 / atol 1e-5 (the JAX package's own tier for
its decode tests, ``tests/test_decode.py``): both sides run the same math
with different summation orders.

Also: the bridge is the exact inverse of JAX's ``convert_lm_state_dict``,
and the port's ``from_pretrained`` loads a snapshot written to a temporary
directory strictly (no JAX model is built for that: JAX's
``tests/test_hf_loading.py`` is ``heavy``).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.models.mamba_lm import MambaLMHeadModel as JLM
from segmamba_tpu.utils.hf import convert_lm_state_dict as j_convert
from segmamba_tpu_torch.models import MambaLMHeadModel
from segmamba_tpu_torch.utils import from_pretrained, lm_flax_to_state_dict
from segmamba_tpu_torch.utils.hf import convert_lm_state_dict

VOCAB, D_MODEL, N_LAYER = 64, 32, 2
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model with the same weights);
    RMSNorm, as the published Mamba LMs."""
    rms = True
    jm = JLM(vocab_size=VOCAB, d_model=D_MODEL, n_layer=N_LAYER,
             rms_norm=rms)
    params = jm.init(jax.random.key(1), jnp.zeros((1, 4), jnp.int32))
    tm = MambaLMHeadModel(VOCAB, D_MODEL, N_LAYER, rms_norm=rms).eval()
    tm.load_state_dict(lm_flax_to_state_dict(params), strict=True)
    return jm, params, tm


def _ids(seed, batch, L):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, L))


def test_forward_logits_match_jax(pair):
    jm, params, tm = pair
    ids = _ids(0, 2, 11)
    want = np.asarray(jm.apply(params, jnp.asarray(ids)))
    for impl in ("auto", "pallas", "fused", "ref"):
        for blk in tm.backbone.layers:
            blk.mixer.scan_impl = impl
        with torch.no_grad():
            got = tm(torch.from_numpy(ids))
        assert got.dtype == torch.float32 and got.shape == (2, 11, VOCAB)
        np.testing.assert_allclose(got.numpy(), want, err_msg=impl, **TOL)
    for blk in tm.backbone.layers:
        blk.mixer.scan_impl = "auto"


def test_prefill_and_steps_match_jax(pair):
    """Prefill hidden states and caches, then three decode steps' logits
    and caches."""
    jm, params, tm = pair
    ids = _ids(1, 2, 9)
    jh, jcaches = jm.apply(params, jnp.asarray(ids),
                           method=lambda m, x: m.backbone.prefill(x))
    with torch.no_grad():
        th, tcaches = tm.backbone.prefill(torch.from_numpy(ids))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for jc, tc in zip(jcaches, tcaches):
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       err_msg=k, **TOL)
    for tok in _ids(2, 3, 2):
        jl, jcaches = jm.apply(params, jnp.asarray(tok), jcaches,
                               method=JLM._logits_step)
        with torch.no_grad():
            th, tcaches = tm.backbone.step(torch.from_numpy(tok), tcaches)
            tl = tm._logits(th)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for jc, tc in zip(jcaches, tcaches):
        np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                                   **TOL)


def test_greedy_generate_matches_jax(pair):
    jm, params, tm = pair
    ids = _ids(3, 2, 7)
    want = np.asarray(jm.apply(params, jnp.asarray(ids), 6,
                               method=JLM.generate))
    got = tm.generate(torch.from_numpy(ids), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_seeded():
    tm = MambaLMHeadModel(VOCAB, D_MODEL, N_LAYER, rms_norm=True)
    ids = torch.from_numpy(_ids(4, 2, 5))
    runs = [tm.generate(ids, 5, temperature=0.8,
                        generator=torch.Generator().manual_seed(s))
            for s in (7, 7)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, 10)
    assert torch.equal(runs[0][:, :5], ids)
    assert int(runs[0].max()) < VOCAB and int(runs[0].min()) >= 0


@pytest.mark.parametrize("rms_norm", [True, False])
def test_bridge_inverts_jax_converter(rms_norm):
    """lm_flax_to_state_dict o convert_lm_state_dict is the identity on a
    reference-named state dict (with and without norm biases)."""
    tm = MambaLMHeadModel(VOCAB, D_MODEL, N_LAYER, rms_norm=rms_norm)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert any(k.endswith("norm.bias") for k in sd) is not rms_norm
    back = lm_flax_to_state_dict(j_convert(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_bridge_roundtrips_jax_tree(pair):
    """convert_lm_state_dict o lm_flax_to_state_dict is the identity on the
    JAX model's flax tree."""
    _, params, _ = pair
    tree = j_convert({k: v.numpy()
                      for k, v in lm_flax_to_state_dict(params).items()})
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(want)
    for path, v in flat:
        np.testing.assert_array_equal(v, want[path])


@pytest.mark.parametrize("rms_norm,name", [(True, "pytorch_model.bin"),
                                           (False, "model.pt"),
                                           (None, "pytorch_model.bin")])
def test_from_pretrained_local_snapshot(tmp_path, rms_norm, name):
    """A snapshot of the reference layout (vocab 50 padded to 56 by
    ``pad_vocab_size_multiple`` 8, tied ``lm_head.weight``, ``module.``
    prefixes) loads strictly and gives the saved model's logits. A config
    without ``rms_norm`` means RMSNorm, as in the JAX loader."""
    src = MambaLMHeadModel(50, 16, 2, rms_norm=rms_norm is not False,
                           pad_vocab_size_multiple=8,
                           generator=torch.Generator().manual_seed(3))
    assert src.vocab_size == 56
    cfg = dict(d_model=16, n_layer=2, vocab_size=50,
               pad_vocab_size_multiple=8)
    if rms_norm is not None:
        cfg["rms_norm"] = rms_norm
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["lm_head.weight"] = src.backbone.embedding.weight.detach().clone()
    torch.save(sd, tmp_path / name)
    model = from_pretrained(str(tmp_path), device="cpu")
    assert (model.vocab_size, model.n_layer) == (56, 2)
    assert model.backbone.rms_norm is (rms_norm is not False)
    ids = torch.from_numpy(_ids(5, 1, 6))
    with torch.no_grad():
        assert torch.equal(model(ids), src(ids))
    assert "lm_head.weight" not in convert_lm_state_dict(sd)
    with pytest.raises(FileNotFoundError):
        from_pretrained(str(tmp_path / "missing"), device="cpu")
