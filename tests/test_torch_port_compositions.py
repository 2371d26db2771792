"""The port's MambaV3 compositions and SegMamba(scan_impl=...) vs the JAX
package, on the CPU.

- ``MambaV3`` under "dir" (with and without ``slice_kernel``), "proj",
  "fused" and "chunked" against the JAX ``MambaV3`` with the same
  ``scan_impl`` (its Pallas kernels in interpret mode, one jitted
  value-and-grad per composition), the weights carried across by
  ``utils/torch_convert._mamba_params``: the output at rtol = atol = 2e-4
  and every parameter gradient at rtol 2e-4 / atol 2e-5 x max|grad| (the
  f32 tiers of tests/test_torch_port_mamba.py and
  tests/test_torch_port_train.py).
- The port's composition selection (``MambaV3.composition``) by device and
  width, and the slice group of the directional conv at nslices below the
  conv width (where the JAX function's one-position carry does not hold).
- The tiny SegMamba with ``scan_impl="proj"`` (num_slices_list 8/8/4/4:
  every stage's nslices >= d_conv - 1, where the JAX directional conv is
  right) against JAX ``SegMamba(scan_impl="proj")``: logits at rtol 2e-3,
  atol 1e-2 x max|ref| (tests/test_torch_port_model.py's tier); one train
  step of the port's "proj" model against JAX's: loss and grad norm at
  rtol 1e-4 (tests/test_torch_port_train.py's tier), marked heavy.

CPU time: about 35 s with a warm JAX cache, the heavy train step another
25 s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.models import SegMamba as JSegMamba
from segmamba_tpu.models.mamba import MambaV3 as JMambaV3
from segmamba_tpu.train import lr_schedules as js
from segmamba_tpu.train.train_state import create_train_state
from segmamba_tpu.train.train_state import default_optimizer as j_default_opt
from segmamba_tpu.train.train_state import train_step as j_train_step
from segmamba_tpu.utils.torch_convert import (
    _mamba_params,
    convert_segmamba_state_dict,
)
from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.models.mamba import (
    MambaV3,
    slice_deinterleave,
    slice_interleave,
)
from segmamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_directional,
)
from segmamba_tpu_torch.train import lr_schedules as ts
from segmamba_tpu_torch.train.train_state import (
    create_train_state as t_create_state,
)
from segmamba_tpu_torch.train.train_state import train_step as t_train_step
from segmamba_tpu_torch.utils.convert import _mamba

TOL = dict(rtol=2e-4, atol=2e-4)
CFG = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
           feat_size=(4, 8, 16, 32), hidden_size=64,
           num_slices_list=(8, 8, 4, 4))


@pytest.mark.parametrize("scan_impl,slice_kernel", [
    ("dir", False), ("dir", True), ("proj", False), ("fused", False),
    ("chunked", False)])
def test_mamba_v3_composition_matches_jax(scan_impl, slice_kernel):
    model = MambaV3(d_model=8, nslices=8, scan_impl=scan_impl,
                    slice_kernel=slice_kernel,
                    generator=torch.Generator().manual_seed(0))
    sd = {f"m.{k}": v for k, v in model.state_dict().items()}
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  _mamba_params(lambda k: sd[k], "m"))
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 64, 8)).astype(np.float32)
    dy = rng.standard_normal((2, 64, 8)).astype(np.float32)
    jm = JMambaV3(d_model=8, nslices=8, scan_impl=scan_impl,
                  slice_kernel=slice_kernel)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(h))
        return jnp.sum(out * dy), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tree)
    out = model(torch.from_numpy(h))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    out.backward(torch.from_numpy(dy))
    wgrads = {}
    _mamba(wgrads, "m", jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        w = np.asarray(wgrads[f"m.{k}"])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=k)


def test_composition_selection():
    """JAX's selection (mamba.py:433-446) with CUDA in the TPU's place."""
    cases = {("auto", 8, "cuda"): "dir2", ("auto", 8, "cpu"): "per_direction",
             ("pallas", 8, "cuda"): "dir2", ("dir2", 8, "cpu"): "dir2",
             ("dir", 8, "cpu"): "dir", ("proj", 64, "cpu"): "proj",
             ("proj", 65, "cpu"): "dir", ("fused", 8, "cuda"): "fused",
             ("chunked", 8, "cuda"): "per_direction",
             ("mxu", 8, "cuda"): "per_direction",
             ("per_direction", 8, "cpu"): "per_direction"}
    for (impl, d_model, device), want in cases.items():
        m = MambaV3(d_model=d_model, nslices=8, scan_impl=impl,
                    generator=torch.Generator().manual_seed(0))
        assert m.composition(device) == want, (impl, d_model, device)
    with pytest.raises(ValueError, match="scan_impl"):
        MambaV3(d_model=8, scan_impl="nope")


def test_proj_falls_to_dir_above_128_channels():
    """d_inner 130 > 128: "proj" runs the unchained dir composition, the
    same numbers as "dir" (and "chunked")."""
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 32, 65)).astype(np.float32))
    outs = []
    for impl in ("proj", "dir", "chunked"):
        m = MambaV3(d_model=65, nslices=4, scan_impl=impl,
                    generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(m(h))
    torch.testing.assert_close(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), outs[2].numpy(), **TOL)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_slice_conv_below_conv_width(S):
    """nslices < d_conv - 1: the slice group still equals the causal conv
    of the interleaved sequence, de-interleaved."""
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((2, 8 * S, 5)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4, 5)).astype(np.float32))
    got = causal_conv1d_directional(x, w, None, activation="silu",
                                    nslices=S)[2]
    want = slice_deinterleave(causal_conv1d(slice_interleave(x, S), w[2],
                                            activation="silu"), S)
    torch.testing.assert_close(got, want)


@pytest.fixture(scope="module")
def proj_pair():
    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     scan_impl="proj", remat="convs", **CFG)
    tree = convert_segmamba_state_dict(model.state_dict(),
                                       depths=CFG["depths"])
    return model, tree


def test_segmamba_proj_matches_jax(proj_pair):
    model, tree = proj_pair
    x = np.random.default_rng(0).standard_normal((1, 2, 32, 32, 32)).astype(
        np.float32)
    jm = JSegMamba(scan_impl="proj", **CFG)
    want = np.moveaxis(np.asarray(jax.jit(jm.apply)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert all(layer.mamba.composition("cpu") == "proj"
               for stage in model.vit.stages for layer in stage)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.heavy
def test_segmamba_proj_train_step_matches_jax(proj_pair):
    """24 s warm, 41 s cold on the CPU (JAX's grad through the
    interpret-mode K8 compiles): the heavy tier."""
    model, tree = proj_pair
    schedule = dict(base_lr=1e-2, max_steps=10)
    jm = JSegMamba(scan_impl="proj", **CFG)
    jstate = create_train_state(
        jm, None, None, params=jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=j_default_opt(js.poly_schedule(**schedule)))
    tstate = t_create_state(model,
                            learning_rate=ts.poly_schedule(**schedule))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 32, 32, 32)).astype(np.float32)
    y = rng.integers(0, 3, (2, 32, 32, 32)).astype(np.int64)
    _, jm_ = j_train_step(jstate, {
        "image": jnp.asarray(np.moveaxis(x, 1, -1)),
        "label": jnp.asarray(y.astype(np.int32))}, num_classes=3)
    tm = t_train_step(tstate, {"image": torch.from_numpy(x),
                               "label": torch.from_numpy(y)},
                      num_classes=3)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm_[key]),
                                   rtol=1e-4, err_msg=key)
