"""Constructor arguments of the JAX models that the port carries:
``MambaV3(bias=True)`` (an out_proj bias, JAX's ``out_proj_bias``) and
``MambaEncoder(out_indices=...)`` (heads and outputs only for the listed
stages), against the JAX package on the CPU, with the weights through the
param bridge (``segmamba_tpu_torch.utils.convert``).

Tolerances in float32: rtol = atol = 2e-4 for the mixer (the scan tier of
tests/test_torch_port_mamba.py); rtol 2e-3 / atol 1e-2 x max|ref| for the
encoder's stage outputs (tests/test_torch_port_model.py's tier: the deep
stages' instance norms over a few voxels amplify rounding).

CPU time: about 15 s (one eager JAX init + apply of the mixer, one jitted
apply of the tiny encoder).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.models.mamba import MambaV3 as JMambaV3
from segmamba_tpu.models.segmamba import MambaEncoder as JMambaEncoder
from segmamba_tpu.utils import torch_convert as tc
from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.models.segmamba import MambaEncoder
from segmamba_tpu_torch.utils.convert import (
    encoder_flax_to_state_dict,
    mamba_flax_to_state_dict,
)

MIXER_TOL = dict(rtol=2e-4, atol=2e-4)
ENC = dict(in_chans=2, depths=(1, 1, 1, 1), dims=(4, 8, 16, 32),
           num_slices_list=(8, 4, 2, 1))


def test_mamba_v3_bias_matches_jax_through_the_bridge():
    """JAX ``MambaV3(bias=True)`` initialised by JAX, its params through
    ``mamba_flax_to_state_dict`` into the port's ``MambaV3(bias=True)``
    (strict): same output; without ``bias`` the port has no out_proj bias."""
    h = np.random.default_rng(0).standard_normal((2, 64, 8)).astype(
        np.float32)
    jm = JMambaV3(d_model=8, nslices=8, bias=True, scan_impl="chunked")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(h))
    want = np.asarray(jm.apply(params, jnp.asarray(h)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert "out_proj_bias" in tree["params"]

    model = MambaV3(d_model=8, nslices=8, bias=True)
    model.load_state_dict(mamba_flax_to_state_dict(tree), strict=True)
    assert model.out_proj.bias is not None
    np.testing.assert_array_equal(model.out_proj.bias.detach().numpy(),
                                  tree["params"]["out_proj_bias"])
    with torch.no_grad():
        got = model(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, **MIXER_TOL)
    assert MambaV3(d_model=8, nslices=8).out_proj.bias is None


def _jax_vit_tree(model):
    """The port encoder's weights as JAX ``MambaEncoder`` params, built with
    the JAX package's own converter pieces (its layout rules); heads only
    for the stages the port keeps."""
    get = lambda k: model.state_dict()[k]
    vit = {"stem": {
        "kernel": tc._conv3d(get("downsample_layers.0.0.weight")),
        "bias": tc._np(get("downsample_layers.0.0.bias"))}}
    for i in range(1, 4):
        vit[f"downsample{i}"] = {
            "kernel": tc._conv3d(get(f"downsample_layers.{i}.1.weight")),
            "bias": tc._np(get(f"downsample_layers.{i}.1.bias"))}
    for i in range(4):
        vit[f"gsc{i}"] = {
            n: {"kernel": tc._conv3d(get(f"gscs.{i}.{n}.weight")),
                "bias": tc._np(get(f"gscs.{i}.{n}.bias"))}
            for n in ("proj", "proj2", "proj3", "proj4")}
        vit[f"stage{i}_block0"] = {
            "LayerNorm_0": {"scale": tc._np(get(f"stages.{i}.0.norm.weight")),
                            "bias": tc._np(get(f"stages.{i}.0.norm.bias"))},
            "mamba": tc._mamba_params(get, f"stages.{i}.0.mamba")}
        if str(i) in model.mlps:
            vit[f"mlp{i}"] = {
                fc: {"kernel": tc._conv3d(get(f"mlps.{i}.{fc}.weight")),
                     "bias": tc._np(get(f"mlps.{i}.{fc}.bias"))}
                for fc in ("fc1", "fc2")}
    return vit


def test_encoder_out_indices_matches_jax_through_the_bridge():
    """``MambaEncoder(out_indices=(1, 3))``: heads for stages 1 and 3 only,
    two outputs, equal to JAX's on a 32^3 input; the bridge carries the
    tree back into a fresh port encoder exactly (strict load)."""
    model = MambaEncoder(out_indices=(1, 3), scan_impl="chunked",
                         generator=torch.Generator().manual_seed(0), **ENC)
    assert sorted(model.mlps) == ["1", "3"]
    vit = _jax_vit_tree(model)
    fresh = MambaEncoder(out_indices=(1, 3), scan_impl="chunked",
                         generator=torch.Generator().manual_seed(1), **ENC)
    fresh.load_state_dict(encoder_flax_to_state_dict(vit), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    x = np.random.default_rng(2).standard_normal((1, 2, 32, 32, 32)).astype(
        np.float32)
    jm = JMambaEncoder(out_indices=(1, 3), scan_impl="chunked", **ENC)
    want = jax.jit(jm.apply)(
        {"params": jax.tree_util.tree_map(jnp.asarray, vit)},
        jnp.asarray(np.moveaxis(x, 1, -1)))
    with torch.no_grad():
        got = fresh(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.moveaxis(np.asarray(w), -1, 1)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3,
                                   atol=1e-2 * np.abs(w).max())
