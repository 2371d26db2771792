"""LR schedules: plain functions of the step that return floats.

Port of ``segmamba_tpu/train/lr_schedules.py``; each factory returns
``schedule(step) -> float``. The optimizer's update k (counted from 0, as
optax counts) uses ``schedule(k)``.

- ``poly_schedule``      — nnU-Net PolyLR, base (1 - t/T)^0.9
- ``poly_with_warmup``   — linear warm-up, then poly
- ``cosine_with_warmup_schedule`` / ``constant_with_warmup_schedule``
- ``linear_warmup_cosine_annealing`` — per epoch
"""

from __future__ import annotations

import math


def _clip01(x):
    return min(max(x, 0.0), 1.0)


def poly_schedule(base_lr: float, max_steps: int, exponent: float = 0.9):
    def schedule(step):
        return base_lr * (1.0 - _clip01(step / max_steps)) ** exponent
    return schedule


def poly_with_warmup(base_lr: float, max_steps: int, warmup_steps: int,
                     exponent: float = 0.9):
    def schedule(step):
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        frac = _clip01((step - warmup_steps)
                       / max(max_steps - warmup_steps, 1))
        return base_lr * (1.0 - frac) ** exponent
    return schedule


def cosine_with_warmup_schedule(base_lr: float, max_steps: int,
                                warmup_steps: int, num_cycles: float = 0.5):
    def schedule(step):
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        progress = _clip01((step - warmup_steps)
                           / max(max_steps - warmup_steps, 1))
        return base_lr * max(
            0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0
                                       * progress)))
    return schedule


def constant_with_warmup_schedule(base_lr: float, warmup_steps: int):
    def schedule(step):
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        return base_lr
    return schedule


def linear_warmup_cosine_annealing(base_lr: float, max_epochs: int,
                                   warmup_epochs: int,
                                   warmup_start_lr: float = 0.0,
                                   eta_min: float = 0.0):
    def schedule(epoch):
        if epoch < warmup_epochs:
            return (warmup_start_lr + (base_lr - warmup_start_lr) * epoch
                    / max(warmup_epochs, 1))
        progress = _clip01((epoch - warmup_epochs)
                           / max(max_epochs - warmup_epochs, 1))
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * progress))
    return schedule
