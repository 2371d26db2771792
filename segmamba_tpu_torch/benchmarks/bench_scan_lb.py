"""Lower-bound probe of the fused forward scan (K10): twin of
``benchmarks/bench_scan_lb.py``.

The probe keeps K2's loads, exps, C-reduction, D-skip and gate and
replaces the Hillis-Steele combine (``_kernel`` :26): ``"noshift"`` runs
the combine's multiply-adds without the shift (7 rounds of
``b = a b 0.5 + b`` on a 128-step chunk, ``a = a a`` after each of the
first 6), ``"nohs"`` only generates and reduces (``x = a b``). Its outputs
are wrong on purpose: it measures where the floor of K2 sits.

- ``variant_call`` takes CPU tensors to ``variant_call_ref`` and CUDA
  tensors to the Hopper kernel ``csrc/scan_lb_fwd.cu``; any other device
  raises. There is no fallback. L must be a multiple of T (the JAX entry
  drops the tail and leaves it unwritten); the kernel takes T = 128 only.
- ``variant_call_ref`` is the plain PyTorch version: ``_kernel``
  transcribed on (R, N, T, D) per chunk, in its order of float
  operations, with the serial carry of the TPU grid (the carry enters at
  step 0 only, and leaves as step T - 1). The kernel recomputes each
  chunk's carry instead and is held against this serial one.
- ``LAUNCHES`` counts the kernel's launches, ``VARIANT_LAUNCHES`` the same
  by variant.
- ``main`` is the script: K2 (``ops.scan_fused.mamba_scan_fused``), then
  both variants, timed by ``microbench.chain_time`` at the JAX script's
  shapes (L = 262,144, D = 96, N = 16, batch 1, bf16)::

      python -m segmamba_tpu_torch.benchmarks.bench_scan_lb
      python -m segmamba_tpu_torch.benchmarks.bench_scan_lb --device cpu \\
          --L 512 --dim 8
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from segmamba_tpu_torch.benchmarks.microbench import (
    chain_time,
    device_name,
    resolve_device,
)
from segmamba_tpu_torch.ops import _build
from segmamba_tpu_torch.ops.scan_dir import _block_channels
from segmamba_tpu_torch.ops.scan_fused import mamba_scan_fused
from segmamba_tpu_torch.ops.selective_scan import _preprocess_delta

LAUNCHES = 0
VARIANTS = ("noshift", "nohs")
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
CHUNK = 128
KERNEL_N = 16
_IO_DTYPES = (torch.float32, torch.bfloat16)
_LIB_NAME = "scan_lb_fwd"


def gated_output(y, u, z, D):
    """(y + D u) * silu(z), cast to u's dtype."""
    zf = z.float()
    y = y + D.float() * u.float()
    return (y * (zf * torch.sigmoid(zf))).to(u.dtype)


def variant_call_ref(u, dt, z, A, B, C, D, dt_bias, variant, T=CHUNK):
    """Plain PyTorch version of ``variant_call``: u/dt/z (R, L, dim), A
    (dim, N), B/C (R, L, N), D/dt_bias (dim,); returns (R, L, dim) in
    u.dtype. The chunks run in order, each from the carry the one before
    it left."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    R, L, dim = u.shape
    if L % T:
        raise ValueError(f"L = {L} is not a multiple of T = {T}")
    delta = _preprocess_delta(dt, dt_bias, True)
    uf = u.float()
    At = A.float().t()[None, :, None, :]            # (1, N, 1, dim)
    Bt = B.float().transpose(1, 2)[..., None]       # (R, N, L, 1)
    Ct = C.float().transpose(1, 2)[..., None]
    out = torch.empty_like(u)
    carry = torch.zeros(R, A.shape[-1], 1, dim, device=u.device)
    for c in range(L // T):
        sl = slice(c * T, (c + 1) * T)
        dl = delta[:, sl]
        a = torch.exp(dl[:, None] * At)             # (R, N, T, dim)
        b = (dl * uf[:, sl])[:, None] * Bt[:, :, sl]
        b = torch.cat([b[:, :, :1] + a[:, :, :1] * carry, b[:, :, 1:]], 2)
        if variant == "noshift":
            k = 1
            while k < T:
                b = a * b * 0.5 + b                 # same op count, no shift
                if 2 * k < T:
                    a = a * a
                k *= 2
            x = b
        else:
            x = a * b                               # generation + reduce only
        y = (Ct[:, :, sl] * x).sum(1)
        out[:, sl] = gated_output(y, u[:, sl], z[:, sl], D)
        carry = x[:, :, T - 1:T]
    return out


def kernel_operands(u, dt, z, A, B, C, D, dt_bias, T):
    """Validate a kernel call's operands: (R, L, dim), N = 16, T = 128, L a
    multiple of T, one I/O dtype on one device, shared parameters. Returns
    the contiguous operands, float32 parameters first."""
    if u.dim() != 3:
        raise ValueError(f"u must be (R, L, dim), got {tuple(u.shape)}")
    R, L, dim = u.shape
    if tuple(A.shape) != (dim, KERNEL_N):
        raise ValueError(f"A: shape {tuple(A.shape)}, expected "
                         f"{(dim, KERNEL_N)} (the kernel is built for "
                         f"N = {KERNEL_N}, shared by the rows)")
    if T != CHUNK:
        raise ValueError(f"the kernel takes T = {CHUNK}, got {T}")
    if L % T:
        raise ValueError(f"L = {L} is not a multiple of T = {T}")
    if u.dtype not in _IO_DTYPES:
        raise ValueError(f"unsupported I/O dtype {u.dtype}")
    shapes = {"dt": (R, L, dim), "z": (R, L, dim), "B": (R, L, KERNEL_N),
              "C": (R, L, KERNEL_N)}
    for name, t in zip(shapes, (dt, z, B, C)):
        if (tuple(t.shape) != shapes[name] or t.dtype != u.dtype
                or t.device != u.device):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; expected {shapes[name]} "
                             f"{u.dtype} on {u.device}")
    params = []
    for name, t, shape in (("A", A, (dim, KERNEL_N)), ("D", D, (dim,)),
                           ("dt_bias", dt_bias, (dim,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        params.append(t.to(device=u.device, dtype=torch.float32).contiguous())
    seq = [t.contiguous() for t in (u, dt, z, B, C)]
    return (*params, *seq)


def variant_call(u, dt, z, A, B, C, D, dt_bias, variant, T=CHUNK):
    """The probe of K2 in ``variant`` ("noshift" or "nohs"): CPU tensors
    run ``variant_call_ref``, CUDA tensors the kernel; shapes as
    ``variant_call_ref``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    if u.device.type == "cpu":
        return variant_call_ref(u, dt, z, A, B, C, D, dt_bias, variant, T)
    return _launch(u, dt, z, A, B, C, D, dt_bias, variant, T)


def check_cuda(u):
    if u.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors; got {u.device}")


def _launch(u, dt, z, A, B, C, D, dt_bias, variant, T):
    """Launch ``scan_lb_fwd`` on the current stream of u's card."""
    global LAUNCHES
    check_cuda(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        out = _run_kernel(_lib(), stream, u, dt, z, A, B, C, D, dt_bias,
                          variant, T)
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
    return out


def _run_kernel(lib, stream, u, dt, z, A, B, C, D, dt_bias, variant, T):
    """Validate the operands, allocate the output on u's device and call
    the library's ``scan_lb_fwd`` on ``stream``."""
    Af, Df, bf, u, dt, z, B, C = kernel_operands(u, dt, z, A, B, C, D,
                                                 dt_bias, T)
    R, L, dim = u.shape
    out = torch.empty_like(u)
    err = lib.scan_lb_fwd(
        u.data_ptr(), dt.data_ptr(), z.data_ptr(), B.data_ptr(),
        C.data_ptr(), Af.data_ptr(), Df.data_ptr(), bf.data_ptr(),
        out.data_ptr(), int(u.dtype == torch.bfloat16),
        VARIANTS.index(variant), R, L, dim, KERNEL_N, T,
        _block_channels(dim), stream)
    if err != 0:
        msg = lib.scan_lb_error_string(err).decode()
        raise RuntimeError(f"scan_lb_fwd launch failed: {msg} ({err})")
    return out


_LIB = None


def _lib():
    """The kernel library with its C signature declared (built on first
    use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load_library(_LIB_NAME)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.scan_lb_fwd.argtypes = [vp] * 9 + [i] * 2 + [ll] * 3 + [i] * 3 \
            + [vp]
        lib.scan_lb_fwd.restype = i
        lib.scan_lb_error_string.argtypes = [i]
        lib.scan_lb_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def bench_inputs(rng, batch, L, E, N, device):
    """The JAX scripts' operands, drawn in their order from ``rng``: bf16
    u, 0.1 dt, z (batch, L, E), float32 A = -exp(normal (E, N)), bf16 B, C
    (batch, L, N), D = 1, bias = 0."""
    seq = lambda *s, sc=1.0: torch.from_numpy(
        sc * rng.standard_normal(s)).to(device, torch.bfloat16)
    u, dt, z = seq(batch, L, E), seq(batch, L, E, sc=0.1), seq(batch, L, E)
    A = -torch.exp(torch.from_numpy(rng.standard_normal((E, N))).to(
        device, torch.float32))
    Bm, Cm = seq(batch, L, N), seq(batch, L, N)
    D = torch.ones(E, device=device)
    bias = torch.zeros(E, device=device)
    return u, dt, z, A, Bm, Cm, D, bias


def parser(description):
    """The twins' options: the JAX scripts' shapes as defaults, and the
    device."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--L", type=int, default=262144)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--k", type=int, default=6,
                    help="applications per timed rep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    args = parser("K10: K2 and its two lower-bound variants, timed."
                  ).parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    inputs = bench_inputs(rng, 1, args.L, args.dim, KERNEL_N, device)
    with torch.no_grad():
        t = chain_time(lambda *a: mamba_scan_fused(*a), inputs, k=args.k)
        print(f"production kernel: {t*1e3:6.2f} ms", flush=True)
        for variant in VARIANTS:
            t = chain_time(lambda *a: variant_call(*a, variant), inputs,
                           k=args.k)
            print(f"variant {variant:8s}: {t*1e3:6.2f} ms", flush=True)


if __name__ == "__main__":
    main()
