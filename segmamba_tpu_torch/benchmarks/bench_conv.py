"""The 3x3x3 conv (K9) against the library conv at the model's decoder
shapes: twin of ``benchmarks/bench_conv.py``.

Forward and value-plus-gradient (the training path) per shape, each timed
by ``microbench.chain_time``: the port's ``ops.conv3d.conv3d_k3s1`` (the
Hopper kernels ``csrc/conv3d_k3s1_fwd.cu`` and ``conv3d_k3s1_dw.cu`` on the
card) beside ``torch_conv``, ``F.conv3d`` on channels_last_3d views of the
same channels-last tensors (cuDNN on the card, ``cudnn.benchmark`` on for
the run). ``torch_conv`` takes the place of the JAX script's ``xla_conv``:
it is the yardstick, and the port's conv path never calls it.

- ``SHAPES``: the JAX script's six (spatial, Cin, Cout), batch 1, bf16.
- ``main`` prints the JAX script's two lines per shape, with the names of
  this card's two convs::

      python -m segmamba_tpu_torch.benchmarks.bench_conv
      python -m segmamba_tpu_torch.benchmarks.bench_conv --device cpu \\
          --spatial 6 --k 1

  ``--device cpu`` runs the plain versions (CPU tensors); ``--spatial``
  replaces every shape's spatial size. On the card, one run launches the
  forward kernel 3 (1 + 3 k) times per shape (the forward's chain, then y
  and dx in the gradient's) and the dw kernel 1 + 3 k times (k = 3 at
  128^3, 5 below, as the JAX script).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from segmamba_tpu_torch.benchmarks.microbench import (
    chain_time,
    device_name,
    resolve_device,
)
from segmamba_tpu_torch.ops.conv3d import conv3d_k3s1

SHAPES = [
    # (spatial, cin, cout)  — decoder/encoder1 hot shapes
    (128, 48, 48),
    (128, 96, 48),   # decoder2 res block first conv (after concat)
    (128, 4, 48),    # encoder1 first conv
    (64, 96, 96),
    (64, 192, 96),
    (32, 192, 192),
]


def torch_conv(x, w):
    """``F.conv3d`` on x (B, D, H, W, Cin) and w (3, 3, 3, Cin, Cout) through
    channels_last_3d views, SAME padding: y (B, D, H, W, Cout)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)


def value_and_grad(conv):
    """The gradients (dx, dw) of sum(conv(x, w)) in float32, as the JAX
    script's ``jax.grad(loss, argnums=(0, 1))``."""
    def run(x, w):
        lx = x.detach().requires_grad_()
        lw = w.detach().requires_grad_()
        conv(lx, lw).float().sum().backward()
        return lx.grad, lw.grad
    return run


def inputs(rng, s, cin, cout, dtype, device):
    """The JAX script's operands, drawn in its order from ``rng``: x
    (1, s, s, s, cin) and w (3, 3, 3, cin, cout) * 0.05."""
    x = torch.from_numpy(rng.standard_normal((1, s, s, s, cin))).to(
        device, dtype)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, cin, cout)) * 0.05).to(
        device, dtype)
    return x, w


def main(argv=None):
    ap = argparse.ArgumentParser(description="K9 against the library conv.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--spatial", type=int, default=None,
                    help="replace every shape's spatial size")
    ap.add_argument("--k", type=int, default=None,
                    help="applications per timed rep (default: 5 at <= 64, "
                         "else 3)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True   # the library conv at its best
    try:
        for s, cin, cout in SHAPES:
            s = args.spatial or s
            x, w = inputs(rng, s, cin, cout, torch.bfloat16, device)
            flops = 2 * s ** 3 * cin * cout * 27
            k = args.k or (5 if s <= 64 else 3)
            with torch.no_grad():
                tx = chain_time(torch_conv, (x, w), k=k)
                tp = chain_time(conv3d_k3s1, (x, w), k=k)
            print(f"{s}^3 {cin}->{cout}: cudnn {tx*1e3:7.2f} ms "
                  f"({flops/tx/1e12:5.1f} Tf/s) | kernel {tp*1e3:7.2f} ms "
                  f"({flops/tp/1e12:5.1f} Tf/s)  [{tx/tp:.2f}x]", flush=True)
            gx = chain_time(value_and_grad(torch_conv), (x, w), k=k)
            gp = chain_time(value_and_grad(conv3d_k3s1), (x, w), k=k)
            print(f"      grad: cudnn {gx*1e3:7.2f} ms | kernel "
                  f"{gp*1e3:7.2f} ms [{gx/gp:.2f}x]", flush=True)
    finally:
        torch.backends.cudnn.benchmark = bench


if __name__ == "__main__":
    main()
