"""Model layer of the port: ``nn.Module``s for SegMamba (NCDHW volumes and
time-major (batch, L, dim) sequences) and the Mamba language model.
Counterpart of ``segmamba_tpu/models``.
"""

from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.models.mamba_lm import (
    Block,
    MambaLMHeadModel,
    MambaUni,
    MixerModel,
)
from segmamba_tpu_torch.models.segmamba import (
    GSC,
    MambaEncoder,
    MambaLayer,
    MlpChannel,
    SegMamba,
)
from segmamba_tpu_torch.models.unetr_blocks import (
    UnetOutBlock,
    UnetResBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
)

__all__ = [
    "Block",
    "MambaLMHeadModel",
    "MambaUni",
    "MambaV3",
    "MixerModel",
    "GSC",
    "MambaEncoder",
    "MambaLayer",
    "MlpChannel",
    "SegMamba",
    "UnetOutBlock",
    "UnetResBlock",
    "UnetrBasicBlock",
    "UnetrUpBlock",
]
