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

Parallel forms (JAX ``mamba.py:395-419``), given a ``mesh``
(``parallel.mesh``), on this rank's rows:

- sequence parallelism over ``seq_axis`` when its ``n`` ranks each get at
  least ``d_conv`` tokens (``L % n == 0``, ``L // n >= d_conv``): the
  forward and flip orientations run ``ops.scan_sharded.mamba_inner_sharded``
  (K6 locally, ``reverse`` for the flip) on this rank's token shard of the
  replicated ``xz``; the slice orientation interleaves the whole ``xz``,
  then shards it, and its output is gathered and de-interleaved; ``out_proj``
  runs on the shard and the output is gathered. The parameters used on the
  shard get their gradients summed over the sequence group.
- tensor parallelism over ``model_axis`` otherwise, when its ranks divide
  d_inner: the layer holds this rank's channel slice of the inner
  parameters (``parallel.tp.tp_shard``) and runs the dir2 composition on
  it (its kernels on the card, at d_inner / n channels); the row-parallel
  ``x_proj``'s partial sums are all-reduced in the projections of every
  orientation and the ``out_proj`` partial products after it
  (``parallel.comm``).

Sequences are time-major (batch, L, d_model).
"""

from __future__ import annotations

import functools
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
from segmamba_tpu_torch.ops.scan_sharded import mamba_inner_sharded
from segmamba_tpu_torch.parallel import comm

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
    ``Mamba(d_model, d_state, d_conv, expand, bimamba_type, nslices)``).
    ``mesh``, ``seq_axis`` and ``model_axis`` select the parallel forms
    (module note); JAX's ``batch_axis`` has no counterpart, since a data
    rank holds its own rows and the layer does no collective over them.
    ``scan_chunk`` is the scan kernels' chunk
    length; ``slice_kernel`` opts ``scan_impl="dir"`` into the slice-order
    kernel. ``dtype`` is the compute dtype; parameters stay float32.
    ``bias`` adds an ``out_proj.bias`` (JAX's ``out_proj_bias``).
    """

    def __init__(self, d_model, d_state=16, d_conv=4, expand=2, dt_rank=None,
                 dt_min=0.001, dt_max=0.1, dt_init_floor=1e-4,
                 conv_bias=True, bias=False, bimamba_type="v3", nslices=None,
                 scan_impl="dir2", scan_chunk=128, slice_kernel=False, *,
                 dtype=torch.float32, generator=None, device=None,
                 mesh=None, seq_axis="seq", model_axis=None):
        super().__init__()
        if bimamba_type not in ("v2", "v3"):
            raise ValueError(f"bimamba_type={bimamba_type!r}; the port has "
                             "the 'v2' and 'v3' forms")
        if scan_impl not in SCAN_IMPLS:
            raise ValueError(f"scan_impl={scan_impl!r}; one of {SCAN_IMPLS}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.mesh, self.seq_axis, self.model_axis = mesh, seq_axis, model_axis
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

    def _direction_params(self, suf, p=None):
        """One direction's parameters in the JAX ops' layout:
        conv (W, E), conv bias, x_proj (E, R+2N), dt_proj (R, E), dt bias,
        A = -exp(A_log) (E, N) float32, D float32. ``p``: the parameters
        by name, to use in place of the module's own."""
        dt = self.dtype
        if p is None:
            conv, xp, dp = (getattr(self, f"conv1d{suf}"),
                            getattr(self, f"x_proj{suf}"),
                            getattr(self, f"dt_proj{suf}"))
            conv_w, conv_b, xp_w, dp_w, dp_b = (
                conv.weight, conv.bias, xp.weight, dp.weight, dp.bias)
            A_log, D = getattr(self, f"A{suf}_log"), getattr(self, f"D{suf}")
        else:
            conv_w, conv_b, xp_w, dp_w, dp_b, A_log, D = (
                p[f"conv1d{suf}.weight"], p.get(f"conv1d{suf}.bias"),
                p[f"x_proj{suf}.weight"], p[f"dt_proj{suf}.weight"],
                p[f"dt_proj{suf}.bias"], p[f"A{suf}_log"], p[f"D{suf}"])
        return (conv_w[:, 0, :].t().to(dt),
                None if conv_b is None else conv_b.to(dt),
                xp_w.t().to(dt), dp_w.t().to(dt), dp_b.float(),
                -torch.exp(A_log.float()), D.float())

    def _stacked(self, sufs):
        """The named directions' conv weight, conv bias, x_proj, dt_proj,
        dt bias, A and D, each stacked on a leading group axis."""
        ps = [self._direction_params(suf) for suf in sufs]
        return tuple(None if p[0] is None else torch.stack(p)
                     for p in zip(*ps))

    def _run_direction(self, xz, suf, impl, reduce=None):
        conv_w, conv_b, x_proj, dt_proj, dt_bias, A, D = (
            self._direction_params(suf))
        return mamba_inner(xz, conv_w, conv_b, x_proj, dt_proj, dt_bias, A,
                           D, d_state=self.d_state, impl=impl,
                           chunk_size=self.scan_chunk, reduce=reduce)

    def _projections(self, xc, x_proj3, dt_proj3, group=None):
        """Grouped projections of the conv output (g, b, L, E): dt, B, C.
        With a tensor-parallel ``group``, E is this rank's channel slice
        and x_proj's partial sums are all-reduced over the group."""
        R, N = self.dt_rank, self.d_state
        x_dbl = torch.einsum("gbld,gde->gble", xc, x_proj3)
        if group is not None:
            x_dbl = comm.sum_shares(x_dbl, group, grad_sum=True)
        dt = torch.einsum("gblr,grd->gbld", x_dbl[..., :R], dt_proj3)
        return dt, x_dbl[..., R:R + N], x_dbl[..., R + N:]

    def _slice_orientation(self, xz, group=None):
        """The slice orientation on an interleaved copy of xz, through
        ``mamba_inner`` "fused" (x_proj's partial sums reduced over a
        tensor-parallel ``group``), de-interleaved."""
        reduce = None if group is None else functools.partial(
            comm.sum_shares, group=group, grad_sum=True)
        out_s = self._run_direction(slice_interleave(xz, self.nslices), "_s",
                                    "fused", reduce)
        return slice_deinterleave(out_s, self.nslices)

    def _run_directions_dir2(self, xz, group=None):
        E = xz.shape[-1] // 2
        conv_w2, conv_b2, x_proj2, dt_proj2, bias2, A2, D2 = self._stacked(
            ("", "_b"))
        x, z = xz[..., :E], xz[..., E:]
        xc = causal_conv1d_directional(x, conv_w2, conv_b2,
                                       activation="silu")   # (2, b, L, E)
        dt, Bm, Cm = self._projections(xc, x_proj2, dt_proj2, group)

        def run(i, **kw):
            return scan_dir.mamba_scan_fused_dir(
                xc[i], dt[i], kw.pop("z", None), A2[i], Bm[i], Cm[i], D2[i],
                bias2[i], chunk_size=self.scan_chunk, **kw)

        acc = run(1, reverse=True, gate=False)
        combined = run(0, acc=acc, z=z, gate=True)
        if self.bimamba_type == "v3":
            combined = combined + self._slice_orientation(xz, group)
        return combined

    def _run_directions_sp(self, xz, group):
        """The three orientations on this rank's token shard (module
        note). Returns (this rank's combined (b, L / n, E), the parameters
        by name with their gradients summed over ``group``)."""
        names = [n for n, _ in self.named_parameters()
                 if not n.startswith("in_proj.")]
        p = dict(zip(names, comm.sum_grads(
            group, *[self.get_parameter(n) for n in names])))

        def run(xz_loc, suf, reverse=False):
            return mamba_inner_sharded(
                xz_loc, *self._direction_params(suf, p), d_state=self.d_state,
                group=group, chunk_size=self.scan_chunk, reverse=reverse)

        xz_loc = comm.shard(xz, 1, group)
        combined = run(xz_loc, "") + run(xz_loc, "_b", reverse=True)
        if self.bimamba_type == "v3":
            S = self.nslices
            out_s = comm.unshard(run(comm.shard(slice_interleave(xz, S), 1,
                                                group), "_s"), 1, group)
            combined = combined + comm.shard(slice_deinterleave(out_s, S), 1,
                                             group)
        return combined, p

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

    def parallel(self, L):
        """The parallel form a sequence of ``L`` tokens takes: "sp", "tp"
        or None (JAX ``mamba.py:395-410``)."""
        if self.mesh is None:
            return None
        n_seq = self.mesh.size(self.seq_axis)
        n_model = (self.mesh.size(self.model_axis)
                   if self.model_axis is not None else 1)
        if n_seq > 1 and n_model > 1:
            raise ValueError("sequence and tensor parallelism together are "
                             "not supported: use one of the two axes")
        if n_seq > 1 and L % n_seq == 0 and L // n_seq >= self.d_conv:
            return "sp"
        if n_model > 1 and self.d_inner % n_model == 0:
            if self.in_proj.weight.shape[0] != 2 * self.d_inner // n_model:
                raise ValueError("tensor parallelism needs this rank's "
                                 "shard of the layer: call "
                                 "parallel.tp.tp_shard first")
            return "tp"
        return None

    def forward(self, hidden_states):
        """hidden_states: (batch, L, d_model) -> same shape, in ``dtype``."""
        L = hidden_states.shape[1]
        if self.bimamba_type == "v3" and (self.nslices is None
                                          or L % self.nslices != 0):
            raise ValueError(f"nslices={self.nslices} must divide L={L}")
        dt = self.dtype
        mode = self.parallel(L)
        if mode == "tp":
            group = self.mesh.group(self.model_axis)
            # the replicated input feeds this rank's columns of in_proj
            hidden_states, = comm.sum_grads(group, hidden_states)
        xz = F.linear(hidden_states.to(dt), self.in_proj.weight.to(dt))
        out_w, out_b = self.out_proj.weight, self.out_proj.bias
        if mode == "sp":
            group = self.mesh.group(self.seq_axis)
            combined, p = self._run_directions_sp(xz, group)
            out_w, out_b = p["out_proj.weight"], p.get("out_proj.bias")
            y = F.linear(combined, out_w.to(dt),
                         None if out_b is None else out_b.to(dt))
            return comm.unshard(y, 1, group)
        if mode == "tp":
            y = F.linear(self._run_directions_dir2(xz, group), out_w.to(dt))
            y = comm.sum_shares(y, group, grad_sum=False)
            return y if out_b is None else y + out_b.to(dt)
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
        return F.linear(combined, out_w.to(dt),
                        None if out_b is None else out_b.to(dt))
