"""The whole port slice vs the JAX package, on the CPU.

Port ``SegMamba`` against JAX ``SegMamba(scan_impl="chunked")`` at the tiny
config of tests/test_torch_convert.py on a 32^3 input (the smallest that
leaves the deepest stage more than one voxel for instance norm), with the
JAX params made from the port's own init through
``convert_segmamba_state_dict`` (no JAX init compile) and a jitted
``apply``. Tolerance: rtol 2e-3, atol 1e-2 * max|ref| in float32, as
tests/test_smoke.py holds the reference torch model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.models import SegMamba as JSegMamba
from segmamba_tpu.utils.torch_convert import convert_segmamba_state_dict
from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.utils.convert import (
    flax_to_state_dict,
    load_flax_params,
)

CFG = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
           feat_size=(4, 8, 16, 32), hidden_size=64,
           num_slices_list=(8, 4, 2, 1))


@pytest.fixture(scope="module")
def pair():
    model = SegMamba(generator=torch.Generator().manual_seed(0), **CFG)
    tree = convert_segmamba_state_dict(model.state_dict(),
                                       depths=CFG["depths"])
    return model, tree


def test_segmamba_matches_jax(pair):
    model, tree = pair
    x = np.random.default_rng(0).standard_normal((1, 2, 32, 32, 32)).astype(
        np.float32)
    jm = JSegMamba(scan_impl="chunked", **CFG)
    want = np.moveaxis(np.asarray(jax.jit(jm.apply)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                               atol=1e-2 * np.abs(want).max())


def test_bridge_round_trip_exact(pair):
    _, tree = pair
    back = convert_segmamba_state_dict(flax_to_state_dict(tree),
                                       depths=CFG["depths"])
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat, flat_back):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=str(path))


def test_load_flax_params_strict(pair):
    model, tree = pair
    fresh = SegMamba(generator=torch.Generator().manual_seed(1), **CFG)
    load_flax_params(fresh, tree)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_parameter_counts_equal(pair):
    model, tree = pair
    n_jax = sum(int(np.prod(np.shape(v)))
                for v in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax
