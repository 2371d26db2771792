"""Trainer: the epoch-driven training loop, on one card or a mesh of ranks.

Port of ``segmamba_tpu/train/trainer.py`` ``Trainer``: ``num_step_per_epoch``
steps of batch ``batch_size`` per epoch, validation every ``val_every``
epochs on ``val_number`` patches with per-class dice, keep-best and final
checkpoints (full state: model, optimizer, step, epoch, metric), resume,
and the subclass hooks ``get_input`` / ``validation_step`` /
``validation_end`` (and ``on_step``, after every step). The model computes in its own ``dtype`` with float32
parameters; the step is ``train_state.train_step``.

Host batches come from ``data.DataLoader`` worker processes; a prefetch
thread pins them and copies them to the card with ``non_blocking`` copies,
so the host's batch work overlaps the previous step. ``device`` defaults to
``"cuda"``; ``"cpu"`` runs everything on the CPU (the scans' plain
versions). Resume continues at the saved epoch and step, as the JAX
trainer does (the saved epoch, finished before its checkpoint, runs once
more). With ``augmentation="device"`` the loader passes the raw patches
(labels -1 where the crop padded) and the augmentation chain runs on the
card inside the train step (``data/augment_device.py``); each step's
parameters are drawn from a generator seeded by (seed + 7, step), so a
resumed run draws what an uninterrupted one would.

With a ``mesh`` (``parallel.mesh``; JAX ``trainer.py:112``) every rank runs
this loop: ``batch_size`` stays the global batch, and each data
coordinate draws its ``batch_size / n_data`` rows from its own stream,
seeded by the coordinate. The ranks of one data coordinate (on the
sequence or model axis) must hold the same rows, as their model needs: the
first of them runs the loaders and broadcasts each batch to the others
(``parallel.mesh.broadcast_tree``), whose worker processes would deliver
in their own order. The device chain's draws are seeded by the data
coordinate and the step, so those ranks draw the same. The parameters
start as rank 0's; a resume reads the checkpoint that rank 0 finds and
hands its contents to every rank. Validation splits ``val_number``
patches over the data ranks as ``parallel.eval`` does (JAX
``trainer.py:264-289``: shards, then the dice lists gathered); only the
main process logs, prints and writes checkpoints. The streams differ from
JAX's single stream, which one program feeds to every device.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from segmamba_tpu_torch.data.augment import (
    get_train_transforms,
    get_train_transforms_noaug,
    get_train_transforms_nomirror,
    get_train_transforms_onlymirror,
    get_train_transforms_onlyspatial,
    get_validation_transforms,
)
from segmamba_tpu_torch.data.augment_device import (
    augment_generator,
    draw_params,
)
from segmamba_tpu_torch.data.loader import DataLoader
from segmamba_tpu_torch.data.patch_sampler import PatchSampler
from segmamba_tpu_torch.parallel.eval import (
    gather_shard_results,
    sequential_shards,
)
from segmamba_tpu_torch.parallel.mesh import broadcast_tree
from segmamba_tpu_torch.parallel.multihost import is_main_process
from segmamba_tpu_torch.train import checkpoint as ckpt
from segmamba_tpu_torch.train.lr_schedules import (
    constant_with_warmup_schedule,
    cosine_with_warmup_schedule,
    poly_schedule,
)
from segmamba_tpu_torch.train.train_state import (
    create_train_state,
    eval_step,
    train_step,
)
from segmamba_tpu_torch.utils.logging import MetricLogger
from segmamba_tpu_torch.utils.misc import set_determinism
from segmamba_tpu_torch.utils.profiling import StepTimer


def _pick_transform(augmentation):
    if augmentation == "device":
        # raw patches go to the card; the chain (RemoveLabel included) runs
        # inside the train step
        return None
    if augmentation in (True, "default"):
        return get_train_transforms()
    if augmentation == "nomirror":
        return get_train_transforms_nomirror()
    if augmentation == "onlymirror":
        return get_train_transforms_onlymirror()
    if augmentation == "onlyspatial":
        return get_train_transforms_onlyspatial()
    return get_train_transforms_noaug()


def _to_device(batch, device):
    """numpy host batch -> tensors on ``device`` (pinned, non-blocking on a
    card)."""
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape"):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=device.type == "cuda")
    return out


def _prefetch(iterator, device, n=2):
    """Yield the batches of ``iterator`` on ``device``, made ready by a
    background thread up to ``n`` ahead. An error in the thread is raised
    here."""
    q = queue_mod.Queue(maxsize=n)
    err = []
    stop = threading.Event()

    def produce():
        try:
            for b in iterator:
                item = _to_device(b, device)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue_mod.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if b is None:
                break
            yield b
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue_mod.Empty:
                pass
        t.join()
    if err:
        raise err[0]


class _Received:
    """The loader of a rank that receives its batches from another: their
    count per epoch."""

    def __init__(self, steps):
        self.steps = steps

    def __len__(self):
        return self.steps

    def start(self):
        pass

    def stop(self):
        pass


class Trainer:
    def __init__(self, model, logdir, *, max_epochs=1000, batch_size=2,
                 val_every=2, num_step_per_epoch=250, val_number=100,
                 patch_size=(128, 128, 128), augmentation=True,
                 learning_rate=1e-2, scheduler_type="poly", loss="ce",
                 num_classes=4, num_workers=8, mesh=None, seed=42,
                 resume=False, device="cuda"):
        self.mesh = mesh
        self.n_data = 1 if mesh is None else mesh.size("data")
        self.data_rank = 0 if mesh is None else mesh.index("data")
        if batch_size % self.n_data:
            raise ValueError(f"batch size {batch_size} does not divide over "
                             f"{self.n_data} data ranks")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.logdir = logdir
        self.model_save_path = os.path.join(logdir, "model")
        self.max_epochs = max_epochs
        self.batch_size = batch_size
        self.val_every = val_every
        self.num_step_per_epoch = num_step_per_epoch
        self.val_number = val_number
        self.patch_size = tuple(patch_size)
        self.augmentation = augmentation
        self.learning_rate = learning_rate
        self.scheduler_type = scheduler_type
        self.loss = loss
        self.num_classes = num_classes
        self.num_workers = num_workers
        self.seed = seed
        self.resume = resume
        self.global_step = 0
        self.epoch = 0
        self.best_mean_dice = 0.0
        self.last_loss = float("nan")
        self.logger = MetricLogger(logdir) if is_main_process() else None
        self.timer = StepTimer(device=self.device)

    def _log(self, key, value, step):
        if self.logger is not None:
            self.logger.log(key, value, step)

    def _print(self, msg):
        if is_main_process():
            print(msg)

    def _rank_seed(self, seed):
        """``seed`` for this data rank's streams (``seed`` itself at data
        rank 0, so a run without data ranks keeps its stream)."""
        return seed + 7919 * self.data_rank

    # -- hooks ---------------------------------------------------------------

    def get_input(self, batch):
        return batch["image"], batch["label"]

    def on_step(self, metrics):
        """After each step (``global_step`` counted, its time recorded):
        logs the loss and gradient norm every 10 steps."""
        if self.global_step % 10 == 0:
            self._log("training_loss", metrics["loss"], self.global_step)
            self._log("grad_norm", metrics["grad_norm"], self.global_step)

    def predict(self, image):
        """Argmax labels of one batch (inference mode)."""
        return eval_step(self.model, image)

    def validation_step(self, state, batch):
        """Patch forward + per-class dice on argmax."""
        image, label = self.get_input(batch)
        pred = self.predict(image).cpu().numpy()
        label = label.cpu().numpy()
        dices = []
        for c in range(1, self.num_classes):
            p, g = pred == c, label == c
            if g.sum() > 0 and p.sum() > 0:
                d = 2.0 * (p & g).sum() / (p.sum() + g.sum())
            elif g.sum() == 0 and p.sum() == 0:
                d = 1.0
            else:
                d = 0.0
            dices.append(float(d))
        return dices

    def validation_end(self, state, val_outputs):
        per_class = np.asarray(val_outputs)  # (n_batches, n_classes-1)
        means = per_class.mean(axis=0)
        mean_dice = float(means.mean())
        for i, m in enumerate(means):
            self._log(f"dice_class_{i + 1}", m, self.epoch)
        self._log("mean_dice", mean_dice, self.epoch)
        self.save_checkpoints(state, mean_dice)
        return mean_dice

    def save_checkpoints(self, state, mean_dice):
        """Keep-best, final, and a ``tmp_model_ep*`` every 100 epochs
        (every rank calls it; the main process writes)."""
        if mean_dice > self.best_mean_dice:
            self.best_mean_dice = mean_dice
            ckpt.save_new_and_delete_last(
                state, self.model_save_path, "best_model", mean_dice,
                self.epoch)
        ckpt.save_new_and_delete_last(
            state, self.model_save_path, "final_model", mean_dice,
            self.epoch)
        if (self.epoch + 1) % 100 == 0:
            ckpt.save_checkpoint(
                state,
                os.path.join(self.model_save_path,
                             f"tmp_model_ep{self.epoch}_{mean_dice:.4f}.pt"),
                epoch=self.epoch, metric=mean_dice)

    # -- internals -------------------------------------------------------------

    def _schedule(self):
        max_steps = self.max_epochs * self.num_step_per_epoch
        if self.scheduler_type == "poly":
            return poly_schedule(self.learning_rate, max_steps)
        if self.scheduler_type == "cosine_with_warmup":
            return cosine_with_warmup_schedule(
                self.learning_rate, max_steps, max_steps // 100)
        if self.scheduler_type == "constant_with_warmup":
            return constant_with_warmup_schedule(
                self.learning_rate, max_steps // 100)
        if self.scheduler_type is None or self.scheduler_type == "constant":
            return self.learning_rate
        raise ValueError(f"unknown scheduler {self.scheduler_type!r}")

    def _build_loaders(self, train_ds, val_ds):
        """This data rank's loaders: its rows of each global batch, and
        its shard of the validation patches (on a rank that receives its
        batches, only their counts)."""
        reps = None if self.mesh is None else self.mesh.replicas()
        if reps is not None and reps[1] != self.mesh.rank:
            n_val = len(sequential_shards(self.val_number, self.n_data)[0][
                self.data_rank])
            return (_Received(self.num_step_per_epoch),
                    _Received(n_val) if val_ds is not None and len(val_ds)
                    else None)
        seed = self._rank_seed(self.seed)
        train_sampler = PatchSampler(
            train_ds, self.patch_size,
            batch_size=self.batch_size // self.n_data,
            rng=np.random.default_rng(seed))
        train_loader = DataLoader(
            train_sampler, transform=_pick_transform(self.augmentation),
            num_workers=self.num_workers,
            steps_per_epoch=self.num_step_per_epoch, seed=seed)
        val_loader = None
        if val_ds is not None and len(val_ds) > 0:
            shards, _ = sequential_shards(self.val_number, self.n_data)
            val_sampler = PatchSampler(
                val_ds, self.patch_size, batch_size=1,
                oversample_foreground_percent=1.0,
                rng=np.random.default_rng(seed + 1))
            val_loader = DataLoader(
                val_sampler, transform=get_validation_transforms(),
                num_workers=min(self.num_workers, 6),
                steps_per_epoch=len(shards[self.data_rank]), seed=seed + 1)
        return train_loader, val_loader

    def train(self, train_dataset, val_dataset=None):
        set_determinism(self.seed)
        state = create_train_state(self.model,
                                   learning_rate=self._schedule(),
                                   mesh=self.mesh)
        n_params = sum(p.numel() for p in self.model.parameters())
        self._print(f"model parameters: {n_params / 1e6:.2f} M")

        start_epoch = 0
        if self.resume:
            # the main process's checkpoint, so that every rank takes the
            # same branch (and the others need not see the file)
            path = (ckpt.find_checkpoint(self.model_save_path, "final_model")
                    if is_main_process() else None)
            if self.mesh is not None:
                box = [path]
                dist.broadcast_object_list(box, src=0)
                path = box[0]
            if path:
                state, start_epoch = ckpt.restore_checkpoint(state, path)
                self.global_step = state.step
                self._print(f"resumed from {path} at epoch {start_epoch}, "
                            f"step {self.global_step}")

        train_loader, val_loader = self._build_loaders(train_dataset,
                                                       val_dataset)
        # start both loaders' processes now: a process's start-up (its
        # imports) takes seconds, and the validation loader's then overlaps
        # the first epoch instead of delaying the first validation
        train_loader.start()
        if val_loader is not None:
            val_loader.start()
        try:
            for epoch in range(start_epoch, self.max_epochs):
                self.epoch = epoch
                state = self.train_epoch(state, train_loader)
                if val_loader is not None and (epoch + 1) % self.val_every == 0:
                    outs = self.validate(state, val_loader)
                    self.validation_end(state, outs)
        finally:
            train_loader.stop()
            if val_loader is not None:
                val_loader.stop()
            if self.logger is not None:
                self.logger.close()
        return state

    def validate(self, state, val_loader):
        """``validation_step`` over this data rank's shard of the
        validation patches; with data ranks, every rank gets all of them
        (in shard order, the wrap-around padding dropped)."""
        own = [self.validation_step(state, b)
               for b in self._batches(val_loader)]
        if self.mesh is None:
            return own
        _, mask = sequential_shards(self.val_number, self.n_data)
        return gather_shard_results(own, mask[self.data_rank],
                                    self.mesh.group("data"))

    def _batches(self, loader):
        """``loader``'s batches on this rank's device, prefetched. Where
        ranks share this rank's data coordinate, the first of them reads
        ``loader`` and broadcasts each batch to the others."""
        reps = None if self.mesh is None else self.mesh.replicas()
        if reps is None:
            yield from _prefetch(iter(loader), self.device)
            return
        group, src = reps
        if self.mesh.rank == src:
            for b in _prefetch(iter(loader), self.device):
                yield broadcast_tree(b, src, group, self.device)
        else:
            for _ in range(len(loader)):
                yield broadcast_tree(None, src, group, self.device)

    def train_epoch(self, state, train_loader):
        """One epoch of ``train_step``s. The timer records each step
        (``step_time``, the card synchronized; with the device chain it
        includes the chain) and the wait for its batch (``data_wait``)."""
        t_epoch = time.time()
        metrics = None
        device_aug = self.augmentation == "device"
        self.timer.mark("data")
        for batch in self._batches(train_loader):
            self.timer.elapsed("data_wait", "data")
            self.timer.mark("step")
            augment = None
            if device_aug:
                augment = draw_params(
                    batch["image"].shape,
                    augment_generator(self._rank_seed(self.seed + 7),
                                      self.global_step),
                    device=self.device)
            metrics = train_step(
                state, {"image": batch["image"], "label": batch["label"]},
                mesh=self.mesh, num_classes=self.num_classes, loss=self.loss,
                augment=augment)
            self.global_step += 1
            self.timer.elapsed("step_time", "step")
            self.on_step(metrics)
            self.timer.mark("data")
        loss = float(metrics["loss"]) if metrics is not None else float("nan")
        stats = self.timer.stats()
        self._print(
            f"epoch {self.epoch} done in {time.time() - t_epoch:.1f}s (loss "
            f"{loss:.4f}; step p50 {stats['step_time']['p50']:.3f}s, max "
            f"{stats['step_time']['max']:.3f}s; data wait max "
            f"{stats['data_wait']['max']:.3f}s)")
        self.last_loss = loss
        return state
