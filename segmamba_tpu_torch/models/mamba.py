"""Tri-oriented Mamba mixer ("bimamba v3"), PyTorch.

Port of ``segmamba_tpu/models/mamba.py`` (``slice_interleave``,
``slice_deinterleave``, ``_dt_bias_init``, ``_a_log_init``, ``MambaV3``).
Three parameter sets — forward, backward (flipped sequence) and inter-slice
(slice-interleaved sequence) — summed before a shared output projection.
Parameter names are the reference torch module's (``in_proj.weight``,
``conv1d_b.weight``, ``A_s_log``, ...), so its ``state_dict`` loads as is.

Two compositions of the directions (``scan_impl``):

- ``"dir2"`` (default, the JAX package's ``_run_directions_dir2``,
  ``mamba.py:246-298``): one directional conv for forward + flip; the flip
  orientation runs the scan kernel right to left in place with no gate and
  hands its partial to the forward orientation through ``acc``, which
  applies the shared ``silu(z)`` gate once; the slice orientation
  interleaves ``xz`` once and runs ``mamba_inner``.
- ``"per_direction"`` (the JAX per-direction path, ``mamba.py:483-493``):
  flip -> ``mamba_inner`` -> flip per direction; the twin dir2 is checked
  against.

Sequences are time-major (batch, L, d_model).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from segmamba_tpu_torch.models.layers import (
    torch_bias_uniform,
    torch_kaiming_uniform,
    uniform,
)
from segmamba_tpu_torch.ops import scan_dir
from segmamba_tpu_torch.ops.causal_conv1d import causal_conv1d_directional
from segmamba_tpu_torch.ops.mamba_inner import mamba_inner

SCAN_IMPLS = ("dir2", "per_direction")


def _dt_bias_init(shape, dt_min, dt_max, dt_init_floor, generator):
    """Inverse softplus of a log-uniform sample in [dt_min, dt_max], on the
    generator's device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min))
    dt = torch.clamp_min(dt, dt_init_floor)
    return dt + torch.log(-torch.expm1(-dt))


def _a_log_init(d_inner, d_state):
    """S4D-real: A = [1..d_state] per channel, stored as log."""
    a = torch.arange(1, d_state + 1, dtype=torch.float32)
    return torch.log(a).repeat(d_inner, 1)


def slice_interleave(x, nslices):
    """Slice-major -> position-major: new[p*ns + s] = old[s*(L/ns) + p]."""
    b, L, c = x.shape
    return x.reshape(b, nslices, L // nslices, c).transpose(1, 2).reshape(
        b, L, c)


def slice_deinterleave(x, nslices):
    """Inverse of ``slice_interleave``."""
    b, L, c = x.shape
    return x.reshape(b, L // nslices, nslices, c).transpose(1, 2).reshape(
        b, L, c)


class _Params(nn.Module):
    """Holds a ``weight`` and optional ``bias`` under torch's names (a
    Linear's (out, in), a depthwise Conv1d's (E, 1, W)); the math is done
    by the caller on the JAX ops' layout."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)


class MambaV3(nn.Module):
    """Tri-oriented selective-state-space mixer.

    Arguments mirror the JAX ``MambaV3`` (and the reference
    ``Mamba(d_model, d_state, d_conv, expand, bimamba_type, nslices)``).
    ``dtype`` is the compute dtype; parameters stay float32.
    """

    def __init__(self, d_model, d_state=16, d_conv=4, expand=2, dt_rank=None,
                 dt_min=0.001, dt_max=0.1, dt_init_floor=1e-4,
                 conv_bias=True, bimamba_type="v3", nslices=None,
                 scan_impl="dir2", *, dtype=torch.float32, generator=None,
                 device=None):
        super().__init__()
        if bimamba_type not in ("v2", "v3"):
            raise ValueError(f"bimamba_type={bimamba_type!r}; the port has "
                             "the 'v2' and 'v3' forms")
        if scan_impl not in SCAN_IMPLS:
            raise ValueError(f"scan_impl={scan_impl!r}; one of {SCAN_IMPLS}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.d_model, self.d_state = d_model, d_state
        self.d_inner = E = expand * d_model
        self.dt_rank = R = dt_rank or math.ceil(d_model / 16)
        self.bimamba_type, self.nslices = bimamba_type, nslices
        self.scan_impl, self.dtype = scan_impl, dtype

        self.in_proj = _Params(torch_kaiming_uniform((2 * E, d_model),
                                                     d_model, g))
        suffixes = ("", "_b", "_s") if bimamba_type == "v3" else ("", "_b")
        for suf in suffixes:
            setattr(self, f"conv1d{suf}", _Params(
                torch_kaiming_uniform((E, 1, d_conv), d_conv, g),
                torch_bias_uniform((E,), d_conv, g) if conv_bias else None))
            setattr(self, f"x_proj{suf}", _Params(
                torch_kaiming_uniform((R + 2 * d_state, E), E, g)))
            setattr(self, f"dt_proj{suf}", _Params(
                uniform((E, R), R ** -0.5, g),
                _dt_bias_init((E,), dt_min, dt_max, dt_init_floor, g)))
            setattr(self, f"A{suf}_log",
                    nn.Parameter(_a_log_init(E, d_state)))
            setattr(self, f"D{suf}", nn.Parameter(torch.ones(E)))
        self.out_proj = _Params(torch_kaiming_uniform((d_model, E), E, g))
        if device is not None:
            self.to(device)

    def _direction_params(self, suf):
        """One direction's parameters in the JAX ops' layout:
        conv (W, E), conv bias, x_proj (E, R+2N), dt_proj (R, E), dt bias,
        A = -exp(A_log) (E, N) float32, D float32."""
        dt = self.dtype
        conv, xp, dp = (getattr(self, f"conv1d{suf}"),
                        getattr(self, f"x_proj{suf}"),
                        getattr(self, f"dt_proj{suf}"))
        return (conv.weight[:, 0, :].t().to(dt),
                None if conv.bias is None else conv.bias.to(dt),
                xp.weight.t().to(dt), dp.weight.t().to(dt), dp.bias.float(),
                -torch.exp(getattr(self, f"A{suf}_log").float()),
                getattr(self, f"D{suf}").float())

    def _run_direction(self, xz, suf):
        conv_w, conv_b, x_proj, dt_proj, dt_bias, A, D = (
            self._direction_params(suf))
        return mamba_inner(xz, conv_w, conv_b, x_proj, dt_proj, dt_bias, A,
                           D, d_state=self.d_state)

    def _run_directions_dir2(self, xz):
        E, R, N = self.d_inner, self.dt_rank, self.d_state
        pf, pb = self._direction_params(""), self._direction_params("_b")
        conv_w2, conv_b2, x_proj2, dt_proj2 = (
            None if p[0] is None else torch.stack(p)
            for p in zip(pf[:4], pb[:4]))
        x, z = xz[..., :E], xz[..., E:]
        xc = causal_conv1d_directional(x, conv_w2, conv_b2,
                                       activation="silu")   # (2, b, L, E)
        x_dbl = torch.einsum("gbld,gde->gble", xc, x_proj2)
        dt = torch.einsum("gblr,grd->gbld", x_dbl[..., :R], dt_proj2)
        Bm = x_dbl[..., R:R + N]
        Cm = x_dbl[..., R + N:]

        def run(i, p, **kw):
            return scan_dir.mamba_scan_fused_dir(
                xc[i], dt[i], kw.pop("z", None), p[5], Bm[i], Cm[i], p[6],
                p[4], **kw)

        acc = run(1, pb, reverse=True, gate=False)
        combined = run(0, pf, acc=acc, z=z, gate=True)
        if self.bimamba_type == "v3":
            out_s = self._run_direction(slice_interleave(xz, self.nslices),
                                        "_s")
            combined = combined + slice_deinterleave(out_s, self.nslices)
        return combined

    def _run_directions_per_direction(self, xz):
        combined = self._run_direction(xz, "")
        combined = combined + self._run_direction(xz.flip(1), "_b").flip(1)
        if self.bimamba_type == "v3":
            out_s = self._run_direction(slice_interleave(xz, self.nslices),
                                        "_s")
            combined = combined + slice_deinterleave(out_s, self.nslices)
        return combined

    def forward(self, hidden_states):
        """hidden_states: (batch, L, d_model) -> same shape, in ``dtype``."""
        L = hidden_states.shape[1]
        if self.bimamba_type == "v3" and (self.nslices is None
                                          or L % self.nslices != 0):
            raise ValueError(f"nslices={self.nslices} must divide L={L}")
        dt = self.dtype
        xz = F.linear(hidden_states.to(dt), self.in_proj.weight.to(dt))
        if self.scan_impl == "dir2":
            combined = self._run_directions_dir2(xz)
        else:
            combined = self._run_directions_per_direction(xz)
        return F.linear(combined, self.out_proj.weight.to(dt))
