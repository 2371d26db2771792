"""Train state and the train step, PyTorch.

Port of ``segmamba_tpu/train/train_state.py`` (``default_optimizer``,
``create_train_state``, ``make_loss_fn``, ``train_step``, ``eval_step``).
Parameters stay float32 and the model computes in its ``dtype`` (bfloat16
for training), as the JAX model does: no autocast, no loss scaling.

With a ``mesh`` (``parallel.mesh``) every rank runs the step on its rows of
the global batch (``parallel.mesh.shard_batch``): ``create_train_state``
makes every rank's parameters rank 0's and, with ``model_axis``, keeps this
rank's tensor-parallel shard of the Mamba-inner ones (``parallel.tp``);
``train_step`` then averages each gradient over the ranks that hold the
same parameter (all ranks, or for a shard the ranks with its model
coordinate), the loss over the data ranks, and clips on the reduced
gradients, the shards' squared norms summed over the model axis. Gradients
of parameters used on a sequence shard are summed over the sequence group
inside the backward already (``models/mamba.py``), so the average over the
sequence ranks is of equal values: it keeps the replicas' bits equal. The
reduction is one all-reduce of all gradients flattened, after the backward,
not DDP: DDP's hooks would run its all-reduces during the backward,
interleaved with the sequence group's collectives in an order that need
not agree across ranks, and it would add nothing the one bucket does not.

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
import torch.distributed as dist

from segmamba_tpu_torch.data.augment_device import device_augment
from segmamba_tpu_torch.parallel import tp
from segmamba_tpu_torch.parallel.mesh import replicated
from segmamba_tpu_torch.train.losses import (
    cross_entropy_loss,
    dice_and_ce_loss,
)


class TrainState:
    """What one training run carries from step to step: the model (its
    float32 parameters), the SGD optimizer (its momentum), the LR schedule,
    the clip norm and the count of updates made; with tensor parallelism,
    the mesh, its model axis and the names of the sharded parameters."""

    def __init__(self, model, optimizer, schedule, grad_clip=12.0, step=0,
                 mesh=None, model_axis=None, sharded=frozenset()):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.step = step
        self.mesh, self.model_axis = mesh, model_axis
        self.sharded = frozenset(sharded)

    def lr(self, step):
        return (self.schedule(step) if callable(self.schedule)
                else float(self.schedule))

    def _param_names(self):
        """The optimizer's parameters' names, in its index order."""
        by_id = {id(p): n for n, p in self.model.named_parameters()}
        return [by_id[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def _momenta(self, osd, fn):
        """``osd`` with ``fn(name, tensor)`` applied to each parameter's
        optimizer tensors (momentum)."""
        names = self._param_names()
        osd = dict(osd)
        osd["state"] = {i: {k: fn(names[i], v) if torch.is_tensor(v)
                            and v.dim() else v for k, v in st.items()}
                        for i, st in osd["state"].items()}
        return osd

    def whole_state(self):
        """(model ``state_dict``, optimizer ``state_dict``) of the whole
        tree: tensor-parallel shards are gathered (a collective: every rank
        calls it), so a checkpoint loads without tensor parallelism."""
        msd, osd = self.model.state_dict(), self.optimizer.state_dict()
        if not self.sharded:
            return msd, osd
        msd = tp.tp_gather_state(msd, self.mesh, self.sharded,
                                 self.model_axis)
        group = self.mesh.group(self.model_axis)
        return msd, self._momenta(osd, lambda n, v: tp.gather_tensor(
            v, tp._leaf_spec(n) if n in self.sharded else None, group))

    def load_whole_state(self, msd, osd):
        """Load a whole tree (``whole_state``'s form), keeping this rank's
        shards under tensor parallelism."""
        if self.sharded:
            n = self.mesh.size(self.model_axis)
            i = self.mesh.index(self.model_axis)
            cut = lambda k, v: tp.shard_tensor(
                v, tp._leaf_spec(k) if k in self.sharded else None, i, n)
            msd = {k: cut(k, v) for k, v in msd.items()}
            osd = self._momenta(osd, cut)
        self.model.load_state_dict(msd)
        self.optimizer.load_state_dict(osd)


def default_optimizer(params, momentum: float = 0.99, nesterov: bool = True,
                      weight_decay: float = 3e-5):
    """SGD of the BraTS recipe; its LR is set from the schedule before every
    update (``train_step``)."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                           nesterov=nesterov, weight_decay=weight_decay)


def create_train_state(model, learning_rate=1e-2, optimizer=None,
                       grad_clip: float = 12.0, mesh=None,
                       model_axis=None) -> TrainState:
    """``learning_rate``: a float or a schedule ``step -> float``. With a
    ``mesh``, every rank's parameters become rank 0's; ``model_axis``
    (an axis of ``mesh``) shards the Mamba-inner parameters over it
    (``parallel.tp.tp_shard``; their momentum follows). An ``optimizer``
    given here must be built after that, on the shards."""
    sharded = ()
    if mesh is not None:
        replicated(model)
        if model_axis is not None:
            sharded = tp.tp_shard(model, mesh, model_axis)
    if optimizer is None:
        optimizer = default_optimizer(model.parameters())
    return TrainState(model, optimizer, learning_rate, grad_clip,
                      mesh=mesh, model_axis=model_axis, sharded=sharded)


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


def _mean_over(tensors, group, n):
    """Average ``tensors`` in place over ``group`` (``n`` ranks): one
    all-reduce of them flattened, in float32."""
    if not tensors or n == 1:
        return
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def reduce_gradients(state: TrainState, mesh):
    """Average every gradient over the ranks that hold its parameter: a
    whole parameter over all ranks, a tensor-parallel shard over the ranks
    with this rank's model coordinate (the data axis)."""
    named = [(n, p) for n, p in state.model.named_parameters()
             if p.grad is not None]
    whole = [p.grad for n, p in named if n not in state.sharded]
    _mean_over(whole, None, dist.get_world_size())
    shards = [p.grad for n, p in named if n in state.sharded]
    if shards and "data" in mesh.axis_names:
        _mean_over(shards, mesh.group("data"), mesh.size("data"))


def apply_gradients(state: TrainState):
    """The optax chain on the gradients in ``.grad``: clip by global norm,
    then SGD (weight decay, nesterov momentum) at ``schedule(step)``;
    counts the update. Returns the norm before clipping (a 0-d tensor):
    under tensor parallelism that of the whole tree, the shards' squared
    norms summed over the model axis."""
    names = state._param_names()
    params = [p for group in state.optimizer.param_groups
              for p in group["params"]]
    grads = [p.grad for p in params if p.grad is not None]
    if state.sharded:
        pick = lambda sh: [p.grad for n, p in zip(names, params)
                           if p.grad is not None and (n in state.sharded)
                           == sh]
        sq_shards = global_norm(pick(True)) ** 2
        dist.all_reduce(sq_shards, group=state.mesh.group(state.model_axis))
        gnorm = torch.sqrt(global_norm(pick(False)) ** 2 + sq_shards)
    else:
        gnorm = global_norm(grads)
    clip_by_global_norm_(grads, gnorm, state.grad_clip)
    lr = state.lr(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return gnorm


def train_step(state: TrainState, batch: dict, *, mesh=None, num_classes=4,
               loss="ce", augment=None) -> dict:
    """One optimization step on ``batch`` ({"image": (B, C, D, H, W),
    "label": (B, D, H, W)} on the model's device; with a ``mesh``, this
    rank's rows of the global batch). ``augment``: the batch's drawn
    augmentation parameters; when given, the device chain runs on the raw
    patches (labels -1 where the crop padded) first. Returns {"loss",
    "grad_norm"} as 0-d tensors on the card (no host sync without a mesh;
    with one, the loss is the data ranks' mean)."""
    model = state.model
    model.train()
    image, label = batch["image"], batch["label"]
    if augment is not None:
        image, label = device_augment(image, label, augment)
    loss_fn = make_loss_fn(loss, num_classes)
    loss_val = loss_fn(model(image), label)
    state.optimizer.zero_grad(set_to_none=True)
    loss_val.backward()
    loss_val = loss_val.detach()
    if mesh is not None:
        reduce_gradients(state, mesh)
        if "data" in mesh.axis_names:
            loss_val = loss_val.clone()
            dist.all_reduce(loss_val, group=mesh.group("data"))
            loss_val /= mesh.size("data")
    gnorm = apply_gradients(state)
    return {"loss": loss_val, "grad_norm": gnorm.detach()}


@torch.inference_mode()
def eval_step(model, image):
    """Forward only, argmax labels (the validation path)."""
    model.eval()
    return torch.argmax(model(image), dim=1)
