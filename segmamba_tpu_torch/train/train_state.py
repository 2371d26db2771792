"""Train state and the train step, PyTorch.

Port of ``segmamba_tpu/train/train_state.py`` (``default_optimizer``,
``create_train_state``, ``make_loss_fn``, ``train_step``, ``eval_step``) on
one card. Parameters stay float32 and the model computes in its ``dtype``
(bfloat16 for training), as the JAX model does: no autocast, no loss
scaling.

The update is the optax chain of the JAX package, in its order:

1. clip by global norm 12 with optax's rule: ``g`` unchanged when
   ``||g|| < 12``, else ``g * 12 / ||g||`` (no epsilon;
   ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and is not used);
2. weight decay: ``g + 3e-5 p``;
3. SGD, nesterov, momentum 0.99: ``torch.optim.SGD(momentum=0.99,
   nesterov=True, weight_decay=3e-5)`` after the clip is steps 2 and 3;
4. the LR of update k (from 0, as optax counts) is ``schedule(k)``.

The reported ``grad_norm`` is the norm before clipping.

With ``augment`` (a batch's ``data.augment_device.AugmentParams``), the
on-device augmentation chain runs on the raw patches before the forward,
as the JAX ``_train_step(augment=True)`` does.
"""

from __future__ import annotations

from typing import Callable

import torch

from segmamba_tpu_torch.data.augment_device import device_augment
from segmamba_tpu_torch.train.losses import (
    cross_entropy_loss,
    dice_and_ce_loss,
)


class TrainState:
    """What one training run carries from step to step: the model (its
    float32 parameters), the SGD optimizer (its momentum), the LR schedule,
    the clip norm and the count of updates made."""

    def __init__(self, model, optimizer, schedule, grad_clip=12.0, step=0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.step = step

    def lr(self, step):
        return (self.schedule(step) if callable(self.schedule)
                else float(self.schedule))


def default_optimizer(params, momentum: float = 0.99, nesterov: bool = True,
                      weight_decay: float = 3e-5):
    """SGD of the BraTS recipe; its LR is set from the schedule before every
    update (``train_step``)."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                           nesterov=nesterov, weight_decay=weight_decay)


def create_train_state(model, learning_rate=1e-2, optimizer=None,
                       grad_clip: float = 12.0) -> TrainState:
    """``learning_rate``: a float or a schedule ``step -> float``."""
    if optimizer is None:
        optimizer = default_optimizer(model.parameters())
    return TrainState(model, optimizer, learning_rate, grad_clip)


def make_loss_fn(loss: str = "ce", num_classes: int = 4) -> Callable:
    if loss == "ce":
        return cross_entropy_loss
    if loss == "dice_ce":
        return dice_and_ce_loss
    raise ValueError(f"unknown loss {loss!r}")


def global_norm(grads):
    """sqrt of the sum of squares of every gradient, in float32."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads, norm, max_norm):
    """optax ``clip_by_global_norm`` in place: unchanged below ``max_norm``,
    else scaled by ``max_norm / norm``. No host sync."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)


def apply_gradients(state: TrainState):
    """The optax chain on the gradients in ``.grad``: clip by global norm,
    then SGD (weight decay, nesterov momentum) at ``schedule(step)``;
    counts the update. Returns the norm before clipping (a 0-d tensor)."""
    grads = [p.grad for group in state.optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    gnorm = global_norm(grads)
    clip_by_global_norm_(grads, gnorm, state.grad_clip)
    lr = state.lr(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return gnorm


def train_step(state: TrainState, batch: dict, *, num_classes=4,
               loss="ce", augment=None) -> dict:
    """One optimization step on ``batch`` ({"image": (B, C, D, H, W),
    "label": (B, D, H, W)} on the model's device). ``augment``: the batch's
    drawn augmentation parameters; when given, the device chain runs on
    the raw patches (labels -1 where the crop padded) first. Returns
    {"loss", "grad_norm"} as 0-d tensors on the card (no host sync)."""
    model = state.model
    model.train()
    image, label = batch["image"], batch["label"]
    if augment is not None:
        image, label = device_augment(image, label, augment)
    loss_fn = make_loss_fn(loss, num_classes)
    loss_val = loss_fn(model(image), label)
    state.optimizer.zero_grad(set_to_none=True)
    loss_val.backward()
    gnorm = apply_gradients(state)
    return {"loss": loss_val.detach(), "grad_norm": gnorm.detach()}


@torch.inference_mode()
def eval_step(model, image):
    """Forward only, argmax labels (the validation path)."""
    model.eval()
    return torch.argmax(model(image), dim=1)
