"""Utilities of the port: the flax param tree -> ``state_dict`` bridge."""

from segmamba_tpu_torch.utils.convert import (
    flax_to_state_dict,
    load_flax_params,
)

__all__ = ["flax_to_state_dict", "load_flax_params"]
