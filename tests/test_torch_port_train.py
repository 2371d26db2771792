"""The port's training path vs the JAX package, on the CPU.

- Losses (all six) against ``segmamba_tpu.train.losses`` on the same
  logits (NCDHW in the port, channels-last in JAX) and labels with ignored
  (-1) voxels: rtol 1e-5 / atol 1e-6 (float32 reductions in other orders).
- LR schedules against ``segmamba_tpu.train.lr_schedules``: rtol 1e-5 /
  atol 1e-9 (1e-7 of the base LR): the port computes in float64, JAX in
  float32, whose (1 - t/T)^0.9 and cosine lose relative precision as t
  nears T.
- Five updates of the optimizer chain (clip 12 -> weight decay 3e-5 ->
  nesterov SGD 0.99, poly LR) against optax's ``default_optimizer`` on a
  toy parameter set whose gradients are large enough to clip: rtol 1e-5.
- ``MambaV3`` dir2 parameter gradients against the JAX
  ``MambaV3(scan_impl="chunked")``: rtol 2e-4 / atol 2e-5 x max|grad|.
- ``remat`` recomputes without changing a gradient bit.
- Train-step parity: the tiny SegMamba of test_torch_port_model.py, batch
  2 x 32^3, float32, three steps of the port's ``train_step`` against the
  JAX ``train_step`` from the same weights and batches (JAX state built
  from the port's init, one JAX compile). Loss and grad_norm per step at
  rtol 1e-4; parameters after step 3 at rtol 1e-3 / atol 1e-5.
- The same with the on-device augmentation chain: JAX's ``train_step(
  augment_key=...)`` against the port's ``train_step(augment=...)`` given
  the same draws, on raw patches with crop padding (-1) in the labels
  (a second JAX train-step compile), at the same tolerances.

CPU time: about 70 s with a warm JAX cache, most of it the two JAX
train-step compiles and the MambaV3 grad compile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from segmamba_tpu.models import SegMamba as JSegMamba
from segmamba_tpu.models.mamba import MambaV3 as JMambaV3
from segmamba_tpu.train import losses as jl
from segmamba_tpu.train import lr_schedules as js
from segmamba_tpu.train.train_state import create_train_state
from segmamba_tpu.train.train_state import default_optimizer as j_default_opt
from segmamba_tpu.train.train_state import train_step as j_train_step
from segmamba_tpu.utils.torch_convert import (
    _mamba_params,
    convert_segmamba_state_dict,
)
from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.train import losses as tl
from segmamba_tpu_torch.train import lr_schedules as ts
from segmamba_tpu_torch.train.train_state import apply_gradients
from segmamba_tpu_torch.train.train_state import (
    create_train_state as t_create_state,
)
from segmamba_tpu_torch.train.train_state import train_step as t_train_step
from segmamba_tpu_torch.utils.convert import _mamba, flax_to_state_dict

CFG = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
           feat_size=(4, 8, 16, 32), hidden_size=64,
           num_slices_list=(8, 4, 2, 1))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _logits_labels(seed=0, C=4, shape=(2, 6, 5, 4)):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((shape[0], C, *shape[1:]))).astype(
        np.float32)
    labels = rng.integers(0, C, shape).astype(np.int64)
    labels[rng.uniform(size=shape) < 0.2] = -1
    return logits, labels


def _j(logits):
    return jnp.asarray(np.moveaxis(logits, 1, -1))


@pytest.mark.parametrize("name", ["ce", "ce_weighted", "topk", "dice",
                                  "dice_batch_nobg", "dice_ce", "dice_bce",
                                  "deep_supervision"])
def test_losses_match_jax(name):
    logits, labels = _logits_labels()
    t_lo, t_la = torch.from_numpy(logits), torch.from_numpy(labels)
    j_lo, j_la = _j(logits), jnp.asarray(labels)
    if name == "ce":
        got = tl.cross_entropy_loss(t_lo, t_la)
        want = jl.cross_entropy_loss(j_lo, j_la)
    elif name == "ce_weighted":
        w = [0.5, 1.0, 2.0, 3.0]
        got = tl.cross_entropy_loss(t_lo, t_la, weights=w)
        want = jl.cross_entropy_loss(j_lo, j_la, weights=w)
    elif name == "topk":
        got = tl.topk_loss(t_lo, t_la, k_percent=10.0)
        want = jl.topk_loss(j_lo, j_la, k_percent=10.0)
    elif name == "dice":
        got = tl.soft_dice_loss(t_lo, t_la)
        want = jl.soft_dice_loss(j_lo, j_la)
    elif name == "dice_batch_nobg":
        got = tl.soft_dice_loss(t_lo, t_la, batch_dice=True,
                                include_background=False)
        want = jl.soft_dice_loss(j_lo, j_la, batch_dice=True,
                                 include_background=False)
    elif name == "dice_ce":
        got = tl.dice_and_ce_loss(t_lo, t_la)
        want = jl.dice_and_ce_loss(j_lo, j_la)
    elif name == "dice_bce":
        regions = (np.random.default_rng(1).uniform(size=logits.shape)
                   < 0.3).astype(np.float32)
        got = tl.dice_and_bce_loss(t_lo, torch.from_numpy(regions))
        want = jl.dice_and_bce_loss(j_lo, _j(regions))
    else:
        lo2, la2 = _logits_labels(2, shape=(2, 3, 3, 2))
        got = tl.deep_supervision_loss(
            tl.cross_entropy_loss, [t_lo, torch.from_numpy(lo2)],
            [t_la, torch.from_numpy(la2)])
        want = jl.deep_supervision_loss(
            jl.cross_entropy_loss, [j_lo, _j(lo2)],
            [j_la, jnp.asarray(la2)])
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_cross_entropy_ignores_every_voxel():
    logits, labels = _logits_labels()
    labels[:] = -1
    assert float(tl.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels))) == 0.0


@pytest.mark.parametrize("name", ["poly", "poly_warmup", "cosine",
                                  "constant", "linear_cosine"])
def test_schedules_match_jax(name):
    make = {
        "poly": lambda m: m.poly_schedule(1e-2, 100),
        "poly_warmup": lambda m: m.poly_with_warmup(1e-2, 100, 10),
        "cosine": lambda m: m.cosine_with_warmup_schedule(1e-2, 100, 10),
        "constant": lambda m: m.constant_with_warmup_schedule(1e-2, 10),
        "linear_cosine": lambda m: m.linear_warmup_cosine_annealing(
            1e-2, 50, 5, warmup_start_lr=1e-4, eta_min=1e-5),
    }[name]
    got, want = make(ts), make(js)
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 120):
        g = got(step)
        assert isinstance(g, float)
        np.testing.assert_allclose(g, float(want(step)), rtol=1e-5,
                                   atol=1e-9, err_msg=str(step))


def test_optimizer_chain_matches_optax():
    """Five updates with the clip active (||g|| ~ 40 > 12)."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(10 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    tx = j_default_opt(js.poly_schedule(1e-2, 20))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    model = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    state = t_create_state(model, learning_rate=ts.poly_schedule(1e-2, 20))
    for k, g in enumerate(grads):
        jg = [jnp.asarray(x) for x in g]
        updates, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(model, g):
            p.grad = torch.from_numpy(x.copy())
        norm = apply_gradients(state)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(jg)), rtol=1e-6)
        assert float(norm) > 12.0 and state.step == k + 1
        for p, q in zip(model, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=1e-5, atol=1e-7, err_msg=str(k))


def test_mamba_v3_grads_match_jax():
    model = MambaV3(d_model=8, nslices=8,
                    generator=torch.Generator().manual_seed(0))
    sd = {f"m.{k}": v for k, v in model.state_dict().items()}
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  _mamba_params(lambda k: sd[k], "m"))
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 64, 8)).astype(np.float32)
    dy = rng.standard_normal((2, 64, 8)).astype(np.float32)
    jm = JMambaV3(d_model=8, nslices=8, scan_impl="chunked")
    jgrads = jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, jnp.asarray(h)) * dy))(tree)
    model(torch.from_numpy(h)).backward(torch.from_numpy(dy))
    want = {}
    _mamba(want, "m", jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        w = np.asarray(want[f"m.{k}"])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("remat", ["convs", True])
def test_remat_keeps_gradients(remat):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 2, 32, 32, 32)).astype(np.float32))
    grads = []
    for r in (False, remat):
        model = SegMamba(generator=torch.Generator().manual_seed(0),
                         remat=r, **CFG)
        model(x).square().mean().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


def test_train_step_matches_jax():
    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     remat="convs", **CFG)
    tree = convert_segmamba_state_dict(model.state_dict(),
                                       depths=CFG["depths"])
    schedule = dict(base_lr=1e-2, max_steps=10)
    jm = JSegMamba(scan_impl="chunked", **CFG)
    jstate = create_train_state(
        jm, None, None, params=jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=j_default_opt(js.poly_schedule(**schedule)))
    tstate = t_create_state(model,
                            learning_rate=ts.poly_schedule(**schedule))
    rng = np.random.default_rng(3)
    for step in range(3):
        x = rng.standard_normal((2, 2, 32, 32, 32)).astype(np.float32)
        y = rng.integers(0, 3, (2, 32, 32, 32)).astype(np.int64)
        jstate, jm_ = j_train_step(jstate, {
            "image": jnp.asarray(np.moveaxis(x, 1, -1)),
            "label": jnp.asarray(y.astype(np.int32))}, num_classes=3)
        tm = t_train_step(tstate, {"image": torch.from_numpy(x),
                                   "label": torch.from_numpy(y)},
                          num_classes=3)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm_[key]),
                                       rtol=1e-4, err_msg=f"{key} {step}")
    assert tstate.step == 3
    want = flax_to_state_dict(jax.tree_util.tree_map(np.array,
                                                     jstate.params))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_train_step_with_device_augment_matches_jax():
    """The augmented step: JAX's ``train_step(augment_key=fold_in(k,
    step))`` against the port's ``train_step(augment=...)`` given the same
    draws (``params_from_key`` of the chain's test), on raw patches whose
    labels hold crop padding (-1). Three steps at the tolerances of
    ``test_train_step_matches_jax``."""
    from test_torch_port_augment_device import params_from_key

    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     remat="convs", **CFG)
    tree = convert_segmamba_state_dict(model.state_dict(),
                                       depths=CFG["depths"])
    schedule = dict(base_lr=1e-2, max_steps=10)
    jm = JSegMamba(scan_impl="chunked", **CFG)
    jstate = create_train_state(
        jm, None, None, params=jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=j_default_opt(js.poly_schedule(**schedule)))
    tstate = t_create_state(model,
                            learning_rate=ts.poly_schedule(**schedule))
    rng = np.random.default_rng(4)
    base = jax.random.key(9)
    for step in range(3):
        x = rng.standard_normal((2, 2, 32, 32, 32)).astype(np.float32)
        y = rng.integers(0, 3, (2, 32, 32, 32)).astype(np.int64)
        y[:, :, :, :5] = -1                    # the crop's padding
        key = jax.random.fold_in(base, step)
        jstate, jm_ = j_train_step(jstate, {
            "image": jnp.asarray(np.moveaxis(x, 1, -1)),
            "label": jnp.asarray(y.astype(np.int32))}, num_classes=3,
            augment_key=key)
        tm = t_train_step(tstate, {"image": torch.from_numpy(x),
                                   "label": torch.from_numpy(y)},
                          num_classes=3,
                          augment=params_from_key(key, x.shape))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=1e-4, err_msg=f"{k} {step}")
    want = flax_to_state_dict(jax.tree_util.tree_map(np.array,
                                                     jstate.params))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
