"""Determinism helper.

Port of ``segmamba_tpu/utils/misc.py`` ``set_determinism``: seeds Python's
``random``, numpy's global generator and torch (CPU and every card), and
returns a ``torch.Generator`` seeded the same, the counterpart of the JAX
version's root key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_determinism(seed: int = 42) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
