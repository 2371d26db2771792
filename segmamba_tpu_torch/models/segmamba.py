"""SegMamba: tri-oriented Mamba encoder + UNETR-style CNN decoder, NCDHW.

Port of ``segmamba_tpu/models/segmamba.py`` (``MambaLayer``, ``MlpChannel``,
``GSC``, ``MambaEncoder``, ``SegMamba``). ``mesh``, ``seq_axis`` and
``model_axis`` go down to every ``MambaV3``, which runs its sequence- or
tensor-parallel form (``models/mamba.py``); everything outside the Mamba
layers is replicated over those groups (every rank computes it whole),
which is the torch form of the JAX layer and block pins (:73-92,
:221-242).
``scan_impl`` goes down to every ``MambaV3`` (``models/mamba.py`` lists the
compositions); the port's default is ``"dir2"``.
``remat`` is the JAX ``remat`` policy (:140-159, :199-213) through
``torch.utils.checkpoint`` (non-reentrant): ``True`` recomputes every Mamba
layer and UNETR block in the backward, ``"convs"`` only the UNETR blocks
(``UnetrBasicBlock``/``UnetrUpBlock``). ``"convs"`` keeps the Mamba layers'
activations: their scans already save only chunk exit states, and
recomputing them would re-run the forward scan kernels in the backward. Module names are the reference model's, so a reference
``state_dict`` (``vit.downsample_layers.0.0.weight``, ``vit.stages.0.0.mamba.
in_proj.weight``, ``decoder5.transp_conv.conv.weight``, ...) loads with
``load_state_dict(strict=True)``.

``dtype`` is the compute dtype; parameters stay float32 and are cast per op.
LayerNorm eps is 1e-5, GELU is exact, logits come out float32.

``num_slices_list`` only orders the slice scan and holds no parameter, so
one set of weights runs any volume: ``with model.slices(counts):`` runs
forwards with other per-stage slice counts (the whole-volume mode's, JAX
``infer/whole_volume.py`` swaps them with ``dataclasses.replace``).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from segmamba_tpu_torch.models.layers import (
    Conv3d,
    InstanceNorm3d,
    instance_norm,
)
from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.models.unetr_blocks import (
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
)


REMAT = (False, "convs", True)


def _call(module, remat, *args):
    """``module(*args)``, recomputed in the backward when ``remat`` and a
    gradient is being recorded."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class MambaLayer(nn.Module):
    """Flatten the volume to (B, L, C) tokens, LayerNorm, tri-oriented Mamba,
    reshape back, residual."""

    def __init__(self, dim, num_slices=None, scan_impl="dir2", *,
                 dtype=torch.float32, generator, **parallel):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.mamba = MambaV3(dim, nslices=num_slices, scan_impl=scan_impl,
                             dtype=dtype, generator=generator, **parallel)

    def forward(self, x):
        b, c = x.shape[:2]
        if c != self.dim:
            raise ValueError(f"expected {self.dim} channels, got {c}")
        spatial = x.shape[2:]
        x_flat = x.flatten(2).transpose(1, 2)                 # (b, L, c)
        x_norm = F.layer_norm(x_flat.float(), (c,), self.norm.weight,
                              self.norm.bias, 1e-5).to(self.dtype)
        y = self.mamba(x_norm)
        return y.transpose(1, 2).reshape(b, c, *spatial) + x


class MlpChannel(nn.Module):
    """1x1x1 conv -> exact GELU -> 1x1x1 conv."""

    def __init__(self, hidden_size, mlp_dim, *, dtype=torch.float32,
                 generator):
        super().__init__()
        self.fc1 = Conv3d(hidden_size, mlp_dim, 1, dtype=dtype,
                          generator=generator)
        self.fc2 = Conv3d(mlp_dim, hidden_size, 1, dtype=dtype,
                          generator=generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class GSC(nn.Module):
    """Gated (by addition) spatial conv block."""

    def __init__(self, in_channels, *, dtype=torch.float32, generator):
        super().__init__()
        c = in_channels
        conv = lambda k, p: Conv3d(c, c, k, 1, p, dtype=dtype,
                                   generator=generator)
        self.proj, self.proj2 = conv(3, 1), conv(3, 1)
        self.proj3, self.proj4 = conv(1, 0), conv(1, 0)

    def forward(self, x):
        cir = lambda conv, h: F.relu(instance_norm(conv(h)))
        x1 = cir(self.proj2, cir(self.proj, x))
        x2 = cir(self.proj3, x)
        return cir(self.proj4, x1 + x2) + x


class MambaEncoder(nn.Module):
    """Four-stage Mamba encoder: stem k7 s2 p3, then 3x (IN + conv k2 s2);
    per stage GSC -> depth x MambaLayer; for each stage in ``out_indices``
    a head IN + MlpChannel (``mlps[str(i)]``), whose outputs are returned
    in stage order, as JAX's ``MambaEncoder.out_indices``."""

    def __init__(self, in_chans=1, depths=(2, 2, 2, 2),
                 dims=(48, 96, 192, 384), num_slices_list=(64, 32, 16, 8),
                 out_indices=(0, 1, 2, 3), scan_impl="dir2", *, remat=False,
                 dtype=torch.float32, generator, **parallel):
        super().__init__()
        g = generator
        self.remat_layers = remat is True
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(Conv3d(in_chans, dims[0], 7, 2, 3, dtype=dtype,
                                  generator=g))]
            + [nn.Sequential(InstanceNorm3d(),
                             Conv3d(dims[i], dims[i + 1], 2, 2, 0,
                                    dtype=dtype, generator=g))
               for i in range(3)])
        self.gscs = nn.ModuleList(
            [GSC(d, dtype=dtype, generator=g) for d in dims])
        self.stages = nn.ModuleList(
            [nn.Sequential(*[MambaLayer(dims[i],
                                        num_slices=num_slices_list[i],
                                        scan_impl=scan_impl, dtype=dtype,
                                        generator=g, **parallel)
                             for _ in range(depths[i])])
             for i in range(4)])
        self.out_indices = tuple(out_indices)
        self.mlps = nn.ModuleDict(
            {str(i): MlpChannel(d, 2 * d, dtype=dtype, generator=g)
             for i, d in enumerate(dims) if i in self.out_indices})

    def forward(self, x):
        outs = []
        for i in range(4):
            x = self.gscs[i](self.downsample_layers[i](x))
            for layer in self.stages[i]:
                x = _call(layer, self.remat_layers, x)
            if i in self.out_indices:
                outs.append(self.mlps[str(i)](instance_norm(x)))
        return tuple(outs)


class SegMamba(nn.Module):
    """Full segmentation model: (B, in_chans, D, H, W) float ->
    (B, out_chans, D, H, W) float32 logits. Defaults are the BraTS config
    (4 -> 4 channels, depths 2/2/2/2, feats 48/96/192/384, hidden 768).
    ``mesh``, ``seq_axis``, ``model_axis``: the parallel forms of the
    Mamba layers (module note)."""

    def __init__(self, in_chans=4, out_chans=4, depths=(2, 2, 2, 2),
                 feat_size: Sequence[int] = (48, 96, 192, 384),
                 hidden_size=768, num_slices_list=(64, 32, 16, 8),
                 scan_impl="dir2", *, remat=False, dtype=torch.float32,
                 generator=None, device=None, mesh=None, seq_axis="seq",
                 model_axis=None):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat={remat!r}; one of {REMAT}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        f, kw = feat_size, dict(dtype=dtype, generator=generator)
        self.dtype, self.remat = dtype, remat
        self.vit = MambaEncoder(in_chans, depths, f, num_slices_list,
                                scan_impl=scan_impl, remat=remat, mesh=mesh,
                                seq_axis=seq_axis, model_axis=model_axis,
                                **kw)
        self.encoder1 = UnetrBasicBlock(in_chans, f[0], **kw)
        self.encoder2 = UnetrBasicBlock(f[0], f[1], **kw)
        self.encoder3 = UnetrBasicBlock(f[1], f[2], **kw)
        self.encoder4 = UnetrBasicBlock(f[2], f[3], **kw)
        self.encoder5 = UnetrBasicBlock(f[3], hidden_size, **kw)
        self.decoder5 = UnetrUpBlock(hidden_size, f[3], **kw)
        self.decoder4 = UnetrUpBlock(f[3], f[2], **kw)
        self.decoder3 = UnetrUpBlock(f[2], f[1], **kw)
        self.decoder2 = UnetrUpBlock(f[1], f[0], **kw)
        self.decoder1 = UnetrBasicBlock(f[0], f[0], **kw)
        self.out = UnetOutBlock(f[0], out_chans, **kw)
        if device is not None:
            self.to(device)

    @property
    def num_slices_list(self):
        """The per-stage slice counts the Mamba layers hold now."""
        return tuple(stage[0].mamba.nslices for stage in self.vit.stages)

    @contextlib.contextmanager
    def slices(self, num_slices_list):
        """Run the forwards inside the block with ``num_slices_list`` as the
        per-stage slice counts; the stored counts come back on exit, also
        when the block raises."""
        counts = tuple(int(n) for n in num_slices_list)
        if len(counts) != len(self.vit.stages):
            raise ValueError(f"{len(counts)} slice counts for "
                             f"{len(self.vit.stages)} stages")
        layers = [(layer.mamba, n) for stage, n in zip(self.vit.stages, counts)
                  for layer in stage]
        saved = [m.nslices for m, _ in layers]
        try:
            for m, n in layers:
                m.nslices = n
            yield self
        finally:
            for (m, _), n in zip(layers, saved):
                m.nslices = n

    def forward(self, x_in):
        outs = self.vit(x_in)
        r = bool(self.remat)
        enc1 = _call(self.encoder1, r, x_in)
        enc2 = _call(self.encoder2, r, outs[0])
        enc3 = _call(self.encoder3, r, outs[1])
        enc4 = _call(self.encoder4, r, outs[2])
        enc_hidden = _call(self.encoder5, r, outs[3])
        dec3 = _call(self.decoder5, r, enc_hidden, enc4)
        dec2 = _call(self.decoder4, r, dec3, enc3)
        dec1 = _call(self.decoder3, r, dec2, enc2)
        dec0 = _call(self.decoder2, r, dec1, enc1)
        return self.out(_call(self.decoder1, r, dec0)).float()
