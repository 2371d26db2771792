"""UNETR-style convolutional blocks, NCDHW.

Port of ``segmamba_tpu/models/unetr_blocks.py`` (``UnetResBlock``,
``UnetrBasicBlock``, ``UnetrUpBlock``, ``UnetOutBlock``). Module names follow
the MONAI blocks the reference model is built from, so the reference
``state_dict`` keys (``...conv1.conv.weight``, ``...transp_conv.conv.weight``)
load as they are. Norms are non-affine InstanceNorm, the activation is
LeakyReLU(0.01), and convs carry no bias except the output head's.
"""

from __future__ import annotations

import torch
from torch import nn

from segmamba_tpu_torch.models.layers import (
    Conv3d,
    ConvTranspose3d,
    instance_norm,
    leaky_relu,
)


class Convolution(nn.Module):
    """Holds one conv under the name ``conv`` (MONAI ``Convolution``)."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


class UnetResBlock(nn.Module):
    """conv-IN-lrelu x2 with an (optionally projected) residual."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, *,
                 dtype=torch.float32, generator):
        super().__init__()
        pad = (kernel_size - 1) // 2
        conv = lambda cin, k, s, p: Convolution(Conv3d(
            cin, out_channels, k, s, p, bias=False, dtype=dtype,
            generator=generator))
        self.conv1 = conv(in_channels, kernel_size, stride, pad)
        self.conv2 = conv(out_channels, kernel_size, 1, pad)
        self.conv3 = (conv(in_channels, 1, stride, 0)
                      if in_channels != out_channels or stride != 1 else None)

    def forward(self, x):
        h = leaky_relu(instance_norm(self.conv1(x)))
        h = instance_norm(self.conv2(h))
        residual = x if self.conv3 is None else instance_norm(self.conv3(x))
        return leaky_relu(h + residual)


class UnetrBasicBlock(nn.Module):
    """Residual basic block (the reference always uses res_block=True)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, *,
                 dtype=torch.float32, generator):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels, kernel_size,
                                  stride, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Transposed-conv x2 upsample, concat skip, residual conv block."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 upsample_kernel_size=2, *, dtype=torch.float32, generator):
        super().__init__()
        self.transp_conv = Convolution(ConvTranspose3d(
            in_channels, out_channels, upsample_kernel_size,
            upsample_kernel_size, bias=False, dtype=dtype,
            generator=generator))
        self.conv_block = UnetResBlock(2 * out_channels, out_channels,
                                       kernel_size, 1, dtype=dtype,
                                       generator=generator)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    """1x1x1 conv with bias to class logits."""

    def __init__(self, in_channels, out_channels, *, dtype=torch.float32,
                 generator):
        super().__init__()
        self.conv = Convolution(Conv3d(in_channels, out_channels, 1, 1, 0,
                                       bias=True, dtype=dtype,
                                       generator=generator))

    def forward(self, x):
        return self.conv(x)
