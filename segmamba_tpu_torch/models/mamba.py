"""Tri-oriented Mamba mixer ("bimamba v3"), PyTorch.

Port of ``segmamba_tpu/models/mamba.py`` (``slice_interleave``,
``slice_deinterleave``, ``_dt_bias_init``, ``_a_log_init``, ``MambaV3``).
Three parameter sets — forward, backward (flipped sequence) and inter-slice
(slice-interleaved sequence) — summed before a shared output projection.
Parameter names are the reference torch module's (``in_proj.weight``,
``conv1d_b.weight``, ``A_s_log``, ...), so its ``state_dict`` loads as is.

Compositions of the directions, chosen by ``scan_impl`` with the JAX
package's names and selection (``mamba.py:433-493``); "on the card" means
a CUDA input, where the JAX package says TPU:

- ``"dir2"`` (the port's default; ``"auto"`` and ``"pallas"`` on the card),
  ``_run_directions_dir2`` (JAX :246-298): one directional conv for forward
  + flip; the flip orientation runs the scan kernel right to left in place
  with no gate and hands its partial to the forward orientation through
  ``acc``, which applies the shared ``silu(z)`` gate once; the slice
  orientation interleaves ``xz`` once and runs ``mamba_inner`` "fused".
- ``"dir"``, ``_run_directions_dir`` (:300-367): forward and flip gated
  apart (K1 each); the slice orientation as dir2's, or, with
  ``slice_kernel=True`` and ``slice_scan_supported``, the zero-copy
  slice-order kernel K5 on the slice group of the directional conv.
- ``"proj"``, ``_run_directions_proj`` (:205-244): the projection-fused
  kernel K8 chained slice -> reverse (``acc``) -> forward (``acc`` and the
  gate); where K8 does not take the layer (``proj_scan_supported``:
  d_inner <= 128, and the chunk's tile in a block's shared memory) it falls
  to ``"dir"``.
- ``"fused"``, ``_run_directions_batched`` (:170-203): the three
  orientations as one batched op (flip and interleave copies, the grouped
  conv, one K2 launch).
- anything else (``"chunked"``, ``"ref"``, ``"mxu"``, ``"auto"`` /
  ``"pallas"`` on the CPU), the per-direction branch (:483-493): flip ->
  ``mamba_inner(impl=scan_impl)`` -> flip per direction. ``"mxu"`` runs
  the ratio-form scan K7 (``scan_mxu``) in each direction, on the card and
  (its plain version) on the CPU. ``"per_direction"`` is the port's alias
  of this branch with ``mamba_inner``'s "auto".

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
from segmamba_tpu_torch.ops import scan_dir, scan_fused, scan_proj
from segmamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d_directional,
    causal_conv1d_grouped,
)
from segmamba_tpu_torch.ops.mamba_inner import mamba_inner

SCAN_IMPLS = ("auto", "pallas", "dir2", "dir", "proj", "fused", "chunked",
              "ref", "mxu", "per_direction")


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
    ``Mamba(d_model, d_state, d_conv, expand, bimamba_type, nslices)``),
    without the mesh arguments. ``scan_chunk`` is the scan kernels' chunk
    length; ``slice_kernel`` opts ``scan_impl="dir"`` into the slice-order
    kernel. ``dtype`` is the compute dtype; parameters stay float32.
    ``bias`` adds an ``out_proj.bias`` (JAX's ``out_proj_bias``).
    """

    def __init__(self, d_model, d_state=16, d_conv=4, expand=2, dt_rank=None,
                 dt_min=0.001, dt_max=0.1, dt_init_floor=1e-4,
                 conv_bias=True, bias=False, bimamba_type="v3", nslices=None,
                 scan_impl="dir2", scan_chunk=128, slice_kernel=False, *,
                 dtype=torch.float32, generator=None, device=None):
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
        self.scan_chunk, self.slice_kernel = scan_chunk, slice_kernel

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
        self.out_proj = _Params(
            torch_kaiming_uniform((d_model, E), E, g),
            torch_bias_uniform((d_model,), E, g) if bias else None)
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

    def _stacked(self, sufs):
        """The named directions' conv weight, conv bias, x_proj, dt_proj,
        dt bias, A and D, each stacked on a leading group axis."""
        ps = [self._direction_params(suf) for suf in sufs]
        return tuple(None if p[0] is None else torch.stack(p)
                     for p in zip(*ps))

    def _run_direction(self, xz, suf, impl):
        conv_w, conv_b, x_proj, dt_proj, dt_bias, A, D = (
            self._direction_params(suf))
        return mamba_inner(xz, conv_w, conv_b, x_proj, dt_proj, dt_bias, A,
                           D, d_state=self.d_state, impl=impl,
                           chunk_size=self.scan_chunk)

    def _projections(self, xc, x_proj3, dt_proj3):
        """Grouped projections of the conv output (g, b, L, E): dt, B, C."""
        R, N = self.dt_rank, self.d_state
        x_dbl = torch.einsum("gbld,gde->gble", xc, x_proj3)
        dt = torch.einsum("gblr,grd->gbld", x_dbl[..., :R], dt_proj3)
        return dt, x_dbl[..., R:R + N], x_dbl[..., R + N:]

    def _slice_orientation(self, xz):
        """The slice orientation on an interleaved copy of xz, through
        ``mamba_inner`` "fused", de-interleaved."""
        out_s = self._run_direction(slice_interleave(xz, self.nslices), "_s",
                                    "fused")
        return slice_deinterleave(out_s, self.nslices)

    def _run_directions_dir2(self, xz):
        E = self.d_inner
        conv_w2, conv_b2, x_proj2, dt_proj2, bias2, A2, D2 = self._stacked(
            ("", "_b"))
        x, z = xz[..., :E], xz[..., E:]
        xc = causal_conv1d_directional(x, conv_w2, conv_b2,
                                       activation="silu")   # (2, b, L, E)
        dt, Bm, Cm = self._projections(xc, x_proj2, dt_proj2)

        def run(i, **kw):
            return scan_dir.mamba_scan_fused_dir(
                xc[i], dt[i], kw.pop("z", None), A2[i], Bm[i], Cm[i], D2[i],
                bias2[i], chunk_size=self.scan_chunk, **kw)

        acc = run(1, reverse=True, gate=False)
        combined = run(0, acc=acc, z=z, gate=True)
        if self.bimamba_type == "v3":
            combined = combined + self._slice_orientation(xz)
        return combined

    def _run_directions_dir(self, xz):
        E, L, S = self.d_inner, xz.shape[1], self.nslices
        use_slice = self.bimamba_type == "v3"
        slice_in_kernel = (use_slice and self.slice_kernel
                           and scan_dir.slice_scan_supported(
                               L, S, self.scan_chunk))
        sufs = ("", "_b", "_s") if slice_in_kernel else ("", "_b")
        conv_w3, conv_b3, x_proj3, dt_proj3, bias3, A3, D3 = self._stacked(
            sufs)
        x, z = xz[..., :E], xz[..., E:]
        xc = causal_conv1d_directional(
            x, conv_w3, conv_b3, activation="silu",
            nslices=S if slice_in_kernel else None)        # (g, b, L, E)
        dt, Bm, Cm = self._projections(xc, x_proj3, dt_proj3)
        args = lambda i: (xc[i], dt[i], z, A3[i], Bm[i], Cm[i], D3[i],
                          bias3[i])
        combined = scan_dir.mamba_scan_fused_dir(
            *args(0), chunk_size=self.scan_chunk)
        combined = combined + scan_dir.mamba_scan_fused_dir(
            *args(1), reverse=True, chunk_size=self.scan_chunk)
        if slice_in_kernel:
            combined = combined + scan_dir.mamba_scan_fused_slice(
                *args(2), nslices=S, chunk_size=self.scan_chunk)
        elif use_slice:
            combined = combined + self._slice_orientation(xz)
        return combined

    def _run_directions_proj(self, xz):
        E, S = self.d_inner, self.nslices
        use_slice = self.bimamba_type == "v3"
        sufs = ("", "_b", "_s") if use_slice else ("", "_b")
        conv_w3, conv_b3, x_proj3, dt_proj3, bias3, A3, D3 = self._stacked(
            sufs)
        x, z = xz[..., :E], xz[..., E:]
        xc = causal_conv1d_directional(
            x, conv_w3, conv_b3, activation="silu",
            nslices=S if use_slice else None)              # (g, b, L, E)

        def run(i, xc_i, **kw):
            return scan_proj.mamba_scan_proj(
                xc_i, x_proj3[i], dt_proj3[i], bias3[i], A3[i], D3[i],
                chunk_size=self.scan_chunk, **kw)

        acc = None
        if use_slice:
            acc = slice_deinterleave(run(2, slice_interleave(xc[2], S)), S)
        acc = run(1, xc[1], reverse=True, acc=acc)
        return run(0, xc[0], acc=acc, z=z)

    def _run_directions_batched(self, xz):
        b, L, _ = xz.shape
        E, S = self.d_inner, self.nslices
        use_slice = self.bimamba_type == "v3"
        branches = [xz, xz.flip(1)]
        sufs = ["", "_b"]
        if use_slice:
            branches.append(slice_interleave(xz, S))
            sufs.append("_s")
        g = len(branches)
        xz3 = torch.cat(branches)                          # (g b, L, 2E)
        conv_w3, conv_b3, x_proj3, dt_proj3, bias3, A3, D3 = self._stacked(
            sufs)
        x3, z3 = xz3[..., :E], xz3[..., E:]
        x3 = causal_conv1d_grouped(x3, conv_w3, conv_b3, b,
                                   activation="silu")
        dt, Bm, Cm = self._projections(x3.reshape(g, b, L, E), x_proj3,
                                       dt_proj3)
        flat = lambda t: t.reshape(g * b, L, t.shape[-1])
        rep = lambda t: t.repeat_interleave(b, dim=0)      # (g b, ...)
        out3 = scan_fused.mamba_scan_fused(
            x3, flat(dt), z3, rep(A3), flat(Bm), flat(Cm), rep(D3),
            rep(bias3), chunk_size=self.scan_chunk).reshape(g, b, L, E)
        combined = out3[0] + out3[1].flip(1)
        if use_slice:
            combined = combined + slice_deinterleave(out3[2], S)
        return combined

    def _run_directions_per_direction(self, xz, impl):
        combined = self._run_direction(xz, "", impl)
        combined = combined + self._run_direction(xz.flip(1), "_b",
                                                  impl).flip(1)
        if self.bimamba_type == "v3":
            out_s = self._run_direction(slice_interleave(xz, self.nslices),
                                        "_s", impl)
            combined = combined + slice_deinterleave(out_s, self.nslices)
        return combined

    def composition(self, device):
        """The composition ``scan_impl`` selects for inputs on ``device``:
        "dir2", "dir", "proj", "fused" or "per_direction"."""
        impl = self.scan_impl
        dirlike = impl in ("dir", "dir2", "proj") or (
            impl in ("auto", "pallas") and torch.device(device).type
            == "cuda")
        if not dirlike:
            return "fused" if impl == "fused" else "per_direction"
        if impl == "proj" and scan_proj.proj_scan_supported(
                self.d_inner, self.dt_rank, self.scan_chunk):
            return "proj"
        return "dir2" if impl in ("dir2", "auto", "pallas") else "dir"

    def forward(self, hidden_states):
        """hidden_states: (batch, L, d_model) -> same shape, in ``dtype``."""
        L = hidden_states.shape[1]
        if self.bimamba_type == "v3" and (self.nslices is None
                                          or L % self.nslices != 0):
            raise ValueError(f"nslices={self.nslices} must divide L={L}")
        dt = self.dtype
        xz = F.linear(hidden_states.to(dt), self.in_proj.weight.to(dt))
        comp = self.composition(xz.device)
        if comp == "dir2":
            combined = self._run_directions_dir2(xz)
        elif comp == "dir":
            combined = self._run_directions_dir(xz)
        elif comp == "proj":
            combined = self._run_directions_proj(xz)
        elif comp == "fused":
            combined = self._run_directions_batched(xz)
        else:
            impl = ("auto" if self.scan_impl == "per_direction"
                    else self.scan_impl)
            combined = self._run_directions_per_direction(xz, impl)
        out_bias = self.out_proj.bias
        return F.linear(combined, self.out_proj.weight.to(dt),
                        None if out_bias is None else out_bias.to(dt))
