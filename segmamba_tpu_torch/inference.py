"""SegMamba forward, or the bench case's sliding-window inference, on one card.

Port of ``0_inference.py``: a forward of the full-width ``SegMamba`` (random
weights from seed 0) on a random 1x4xSxSxS volume, or with ``--case`` the
sliding-window inference ``bench.py`` times — one 150x180x150 four-modality
case, roi 128^3, overlap 0.5, gaussian blending, sw_batch 1 (8 windows).
Volumes are NCDHW. With ``--device cuda`` and no card it raises; it never
falls back to the CPU.

    python -m segmamba_tpu_torch.inference [--size 128] [--dtype bfloat16]
        [--device cuda] [--case]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from segmamba_tpu_torch.infer import sliding_window_inference
from segmamba_tpu_torch.models import SegMamba

CASE_SHAPE = (150, 180, 150)
ROI = (128, 128, 128)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128,
                    help="edge of the random input volume (forward mode)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case", action="store_true",
                    help="run the bench case's sliding-window inference")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device available")
    dtype = getattr(torch, args.dtype)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    model = SegMamba(in_chans=4, out_chans=4, dtype=dtype,
                     generator=torch.Generator().manual_seed(0),
                     device=device).eval()
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        if args.case:
            case = torch.from_numpy(rng.standard_normal(
                (1, 4, *CASE_SHAPE)).astype(np.float32)).to(device)
            print(f"device: {name}; case {tuple(case.shape)}, roi {ROI}")
            run = lambda: sliding_window_inference(
                case, ROI, model, overlap=0.5, sw_batch_size=1,
                compute_dtype=dtype)
        else:
            s = args.size
            x = torch.from_numpy(rng.standard_normal(
                (1, 4, s, s, s)).astype(np.float32)).to(device)
            print(f"device: {name}; input {tuple(x.shape)}")
            run = lambda: model(x)
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        second = time.perf_counter() - t0
    print(f"logits: {tuple(out.shape)} {out.dtype} (first run "
          f"{first:.3f} s, second run {second:.3f} s"
          f"{' per case' if args.case else ''})")
    n = sum(p.numel() for p in model.parameters())
    print(f"params: {n / 1e6:.2f} M")


if __name__ == "__main__":
    main()
