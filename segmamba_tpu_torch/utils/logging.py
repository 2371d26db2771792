"""Metric logging: TensorBoard (when available) + JSONL.

Port of ``segmamba_tpu/utils/logging.py`` ``MetricLogger``: the same
``log(key, value, step)`` surface writes TensorBoard events through
tensorboardX when it is installed and always appends machine-readable JSONL
(``metrics.jsonl``).
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, logdir, enable_tensorboard=True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir=logdir)

    def log(self, key, value, step):
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(key, value, step)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "key": key, "value": value, "step": int(step)})
            + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
