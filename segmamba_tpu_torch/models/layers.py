"""Common layers and the JAX package's torch-parity initializers, NCDHW.

Port of ``segmamba_tpu/models/layers.py`` (``torch_kaiming_uniform``,
``torch_bias_uniform``, ``instance_norm``, ``Conv3d``, ``ConvTranspose3d``,
``leaky_relu``). The JAX conv dispatch forms (einsum / space-to-depth /
folded conv2d, ``layers.py:108-185``) are TPU workarounds and are not
ported: convs here are ``F.conv3d`` / ``F.conv_transpose3d``.

Casting mirrors the JAX package: parameters are float32 and are cast to the
layer's compute ``dtype`` per op; the input is cast to it too.
Initialisation draws from an explicit ``torch.Generator`` on the device
of that generator: a CPU generator gives the same weights on every device,
a CUDA one builds a large model on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def torch_kaiming_uniform(shape, fan_in, generator):
    """torch's default Linear/Conv weight init, kaiming_uniform(a=sqrt(5)):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); a float32 CPU tensor."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return uniform(shape, bound, generator)


def torch_bias_uniform(shape, fan_in, generator):
    """torch's default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return torch_kaiming_uniform(shape, fan_in, generator)


def uniform(shape, bound, generator):
    """U(-bound, bound), float32, on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if bound > 0:
        return t.uniform_(-bound, bound, generator=generator)
    return t.zero_()


def instance_norm(x, eps=1e-5):
    """Non-affine InstanceNorm over the spatial dims of an NCDHW volume
    (``nn.InstanceNorm3d`` defaults). Statistics in float32, normalisation
    in the storage dtype, as the JAX package does (``layers.py:44-52``)."""
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf * xf).mean(dim=axes, keepdim=True) - mean * mean
    scale = torch.rsqrt(torch.clamp_min(var, 0.0) + eps)
    return (x - mean.to(x.dtype)) * scale.to(x.dtype)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


class InstanceNorm3d(nn.Module):
    """Parameter-free module form of ``instance_norm`` (for Sequentials whose
    indices the reference ``state_dict`` names depend on)."""

    def forward(self, x):
        return instance_norm(x)


class Conv3d(nn.Module):
    """3-D conv, NCDHW, torch weight layout (Cout, Cin, kz, ky, kx)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, bias=True, *, dtype=torch.float32, generator):
        super().__init__()
        k = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(
            kernel_size)
        fan_in = in_channels * math.prod(k)
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch_kaiming_uniform(
            (out_channels, in_channels, *k), fan_in, generator))
        self.bias = (nn.Parameter(torch_bias_uniform(
            (out_channels,), fan_in, generator)) if bias else None)

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv3d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding)


class ConvTranspose3d(nn.Module):
    """Transposed 3-D conv (the decoder's k = s upsampling), NCDHW, torch
    weight layout (Cin, Cout, kz, ky, kx); init fan_in = Cin * k^3 as in the
    JAX package."""

    def __init__(self, in_channels, out_channels, kernel_size=2, stride=2,
                 bias=False, *, dtype=torch.float32, generator):
        super().__init__()
        fan_in = in_channels * kernel_size ** 3
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch_kaiming_uniform(
            (in_channels, out_channels, *(kernel_size,) * 3), fan_in,
            generator))
        self.bias = (nn.Parameter(torch_bias_uniform(
            (out_channels,), fan_in, generator)) if bias else None)

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose3d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride)
