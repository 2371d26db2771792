"""Trainer: the epoch-driven training loop on one card.

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
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time

import numpy as np
import torch

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


class Trainer:
    def __init__(self, model, logdir, *, max_epochs=1000, batch_size=2,
                 val_every=2, num_step_per_epoch=250, val_number=100,
                 patch_size=(128, 128, 128), augmentation=True,
                 learning_rate=1e-2, scheduler_type="poly", loss="ce",
                 num_classes=4, num_workers=8, seed=42, resume=False,
                 device="cuda"):
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
        self.logger = MetricLogger(logdir)
        self.timer = StepTimer(device=self.device)

    # -- hooks ---------------------------------------------------------------

    def get_input(self, batch):
        return batch["image"], batch["label"]

    def on_step(self, metrics):
        """After each step (``global_step`` counted, its time recorded):
        logs the loss and gradient norm every 10 steps."""
        if self.global_step % 10 == 0:
            self.logger.log("training_loss", metrics["loss"],
                            self.global_step)
            self.logger.log("grad_norm", metrics["grad_norm"],
                            self.global_step)

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
            self.logger.log(f"dice_class_{i + 1}", m, self.epoch)
        self.logger.log("mean_dice", mean_dice, self.epoch)
        self.save_checkpoints(state, mean_dice)
        return mean_dice

    def save_checkpoints(self, state, mean_dice):
        """Keep-best, final, and a ``tmp_model_ep*`` every 100 epochs."""
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
        train_sampler = PatchSampler(
            train_ds, self.patch_size, batch_size=self.batch_size,
            rng=np.random.default_rng(self.seed))
        train_loader = DataLoader(
            train_sampler, transform=_pick_transform(self.augmentation),
            num_workers=self.num_workers,
            steps_per_epoch=self.num_step_per_epoch, seed=self.seed)
        val_loader = None
        if val_ds is not None and len(val_ds) > 0:
            val_sampler = PatchSampler(
                val_ds, self.patch_size, batch_size=1,
                oversample_foreground_percent=1.0,
                rng=np.random.default_rng(self.seed + 1))
            val_loader = DataLoader(
                val_sampler, transform=get_validation_transforms(),
                num_workers=min(self.num_workers, 6),
                steps_per_epoch=self.val_number, seed=self.seed + 1)
        return train_loader, val_loader

    def train(self, train_dataset, val_dataset=None):
        set_determinism(self.seed)
        state = create_train_state(self.model,
                                   learning_rate=self._schedule())
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"model parameters: {n_params / 1e6:.2f} M")

        start_epoch = 0
        if self.resume:
            path = ckpt.find_checkpoint(self.model_save_path, "final_model")
            if path:
                state, start_epoch = ckpt.restore_checkpoint(state, path)
                self.global_step = state.step
                print(f"resumed from {path} at epoch {start_epoch}, step "
                      f"{self.global_step}")

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
            self.logger.close()
        return state

    def validate(self, state, val_loader):
        """``validation_step`` over the validation stream (one card)."""
        return [self.validation_step(state, b)
                for b in _prefetch(iter(val_loader), self.device)]

    def train_epoch(self, state, train_loader):
        """One epoch of ``train_step``s. The timer records each step
        (``step_time``, the card synchronized; with the device chain it
        includes the chain) and the wait for its batch (``data_wait``)."""
        t_epoch = time.time()
        metrics = None
        device_aug = self.augmentation == "device"
        self.timer.mark("data")
        for batch in _prefetch(iter(train_loader), self.device):
            self.timer.elapsed("data_wait", "data")
            self.timer.mark("step")
            augment = None
            if device_aug:
                augment = draw_params(
                    batch["image"].shape,
                    augment_generator(self.seed + 7, self.global_step),
                    device=self.device)
            metrics = train_step(
                state, {"image": batch["image"], "label": batch["label"]},
                num_classes=self.num_classes, loss=self.loss,
                augment=augment)
            self.global_step += 1
            self.timer.elapsed("step_time", "step")
            self.on_step(metrics)
            self.timer.mark("data")
        loss = float(metrics["loss"]) if metrics is not None else float("nan")
        stats = self.timer.stats()
        print(f"epoch {self.epoch} done in {time.time() - t_epoch:.1f}s "
              f"(loss {loss:.4f}; step p50 {stats['step_time']['p50']:.3f}s"
              f", max {stats['step_time']['max']:.3f}s; data wait max "
              f"{stats['data_wait']['max']:.3f}s)")
        self.last_loss = loss
        return state
