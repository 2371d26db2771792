"""Port MambaV3 and its ops vs the JAX package, on the CPU.

Same weights through the converter (the port's ``state_dict`` ->
``segmamba_tpu.utils.torch_convert`` -> flax tree), same numpy inputs.
Tolerances in float32: rtol = atol = 2e-4 for the mixer (the scan tier of
tests/test_scan_dir_chain.py) and 1e-5 for the convs (a handful of f32
multiply-adds).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.models.mamba import MambaV3 as JMambaV3
from segmamba_tpu.models.mamba import slice_deinterleave as j_deinterleave
from segmamba_tpu.models.mamba import slice_interleave as j_interleave
from segmamba_tpu.ops.causal_conv1d import causal_conv1d as j_conv
from segmamba_tpu.ops.causal_conv1d import (
    causal_conv1d_directional as j_conv_dir,
)
from segmamba_tpu.utils.torch_convert import _mamba_params
from segmamba_tpu_torch.models.mamba import (
    MambaV3,
    slice_deinterleave,
    slice_interleave,
)
from segmamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_directional,
)

TOL = dict(rtol=2e-4, atol=2e-4)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)


def _port_mamba(scan_impl="dir2"):
    return MambaV3(d_model=8, nslices=8, scan_impl=scan_impl,
                   generator=torch.Generator().manual_seed(0))


def _flax_tree(model):
    sd = {f"m.{k}": v for k, v in model.state_dict().items()}
    return {"params": jax.tree_util.tree_map(
        jnp.asarray, _mamba_params(lambda k: sd[k], "m"))}


def test_mamba_v3_dir2_matches_jax():
    model = _port_mamba()
    h = np.random.default_rng(0).standard_normal((2, 512, 8)).astype(
        np.float32)
    jm = JMambaV3(d_model=8, nslices=8, scan_impl="dir2")
    want = jax.jit(jm.apply)(_flax_tree(model), jnp.asarray(h))
    with torch.no_grad():
        got = model(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_per_direction_twin_matches_dir2():
    """flip -> scan -> flip per direction == the chained dir2 composition."""
    dir2, per_dir = _port_mamba(), _port_mamba("per_direction")
    per_dir.load_state_dict(dir2.state_dict())
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 512, 8)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(per_dir(h).numpy(), dir2(h).numpy(),
                                   **TOL)


def test_mamba_v3_input_checks():
    with pytest.raises(ValueError, match="nslices"):
        _port_mamba()(torch.zeros(1, 12, 8))
    with pytest.raises(ValueError, match="bimamba_type"):
        MambaV3(d_model=8, bimamba_type="none")


@pytest.mark.parametrize("G", [2, 3])
def test_causal_conv1d_directional_matches_jax(G):
    rng = np.random.default_rng(G)
    x = rng.standard_normal((2, 48, 6)).astype(np.float32)
    w = rng.standard_normal((G, 4, 6)).astype(np.float32)
    b = rng.standard_normal((G, 6)).astype(np.float32)
    want = j_conv_dir(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      activation="silu", nslices=4 if G == 3 else None)
    got = causal_conv1d_directional(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        activation="silu", nslices=4 if G == 3 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 33, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                  activation="silu")
    got = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), activation="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("nslices", [1, 4, 8])
def test_slice_interleave_round_trip(nslices):
    x = np.random.default_rng(8).standard_normal((2, 64, 3)).astype(
        np.float32)
    t = torch.from_numpy(x)
    il = slice_interleave(t, nslices)
    np.testing.assert_array_equal(il.numpy(), np.asarray(
        j_interleave(jnp.asarray(x), nslices)))
    np.testing.assert_array_equal(slice_deinterleave(il, nslices).numpy(), x)
    np.testing.assert_array_equal(
        slice_deinterleave(t, nslices).numpy(),
        np.asarray(j_deinterleave(jnp.asarray(x), nslices)))
