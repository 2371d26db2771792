"""Utilities of the port: the flax param tree -> ``state_dict`` bridges
(SegMamba and the Mamba LM), local pretrained-LM loading, metric logging,
determinism and step timing."""

from segmamba_tpu_torch.utils.convert import (
    flax_to_state_dict,
    lm_flax_to_state_dict,
    load_flax_params,
)
from segmamba_tpu_torch.utils.hf import from_pretrained
from segmamba_tpu_torch.utils.logging import MetricLogger
from segmamba_tpu_torch.utils.misc import set_determinism
from segmamba_tpu_torch.utils.profiling import StepTimer

__all__ = ["MetricLogger", "StepTimer", "flax_to_state_dict",
           "from_pretrained", "lm_flax_to_state_dict", "load_flax_params",
           "set_determinism"]
