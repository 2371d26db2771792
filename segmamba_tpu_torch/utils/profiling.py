"""Step timing.

Port of ``segmamba_tpu/utils/profiling.py`` ``StepTimer``: rolling
wall-clock statistics for loop phases. On a card the timer synchronizes it
before reading the clock, so a phase's time is the device work it
launched, not the time to enqueue it.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class StepTimer:
    """Rolling wall-clock stats for loop phases (data/compute/total)."""

    def __init__(self, window=100, device="cpu"):
        self.window = window
        self.device = torch.device(device)
        self._marks = {}
        self._series = {}

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name):
        self._marks[name] = self._now()

    def elapsed(self, name, since):
        dt = self._now() - self._marks[since]
        self._series.setdefault(name, []).append(dt)
        if len(self._series[name]) > self.window:
            self._series[name].pop(0)
        return dt

    def last(self, name):
        """The latest time recorded under ``name``."""
        return self._series[name][-1]

    def stats(self):
        return {k: {"mean": float(np.mean(v)), "p50": float(np.median(v)),
                    "max": float(np.max(v))}
                for k, v in self._series.items() if v}
