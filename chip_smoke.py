"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path (``segmamba_tpu_torch``) through the entry
points a user calls, at the full width of the BraTS SegMamba, and checks it.
Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), a CUDA card
   required, the scan kernel built from ``segmamba_tpu_torch/csrc``.
2. Kernel vs plain PyTorch at the main path's shapes (stage 0: R=1,
   L=262144, D=96; stage 3: R=1, L=512, D=768; N=16) for the three flag
   sets the path launches (dir reverse ungated, dir gate + acc, fused gate
   with shared params) plus the chunk exit states; float32 at rtol 6e-4 /
   atol 2e-3, bfloat16 I/O compared in float32 at rtol 3e-2 / atol 5e-2.
   Times by CUDA events, median of several runs.
3. Full-width SegMamba forward on 1x4x128^3 (random weights, seed 0):
   float32 kernel path vs the same model on the plain scans (rtol 2e-3,
   atol 1e-2 * max|ref|); bfloat16 logits finite, their deviation from
   float32 and the ms per window.
4. The bench case's sliding-window inference (150x180x150x4 from
   numpy.random.default_rng(0), roi 128^3, overlap 0.5, gaussian, sw_batch
   1, bfloat16): one warm-up, then timed runs; logits finite; the scan
   launch counters must rise by exactly 128 (scan_dir) and 64 (scan_fused)
   per case (8 windows x 8 Mamba layers x 2 and x 1).

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from segmamba_tpu_torch.infer import sliding_window_inference
from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.models.mamba import _dt_bias_init
from segmamba_tpu_torch.ops import _build, scan_dir, scan_fused

SOURCE = "segmamba_tpu_torch/csrc/gated_scan_fwd.cu"
REPLACES = {
    "scan_dir": "segmamba_tpu/ops/scan_pallas_dir.py:60",
    "scan_fused": "segmamba_tpu/ops/scan_pallas_fused.py:42",
}
SHAPES = {"stage0": (1, 262144, 96), "stage3": (1, 512, 768)}
N = 16
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
CASE_SHAPE = (150, 180, 150)
ROI = (128, 128, 128)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps, warmup=1):
    """Median milliseconds of ``fn`` by CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_scans():
    """Route the model's scans to the plain PyTorch versions (comparison
    only; the wrappers' launch counters must not move)."""
    saved = scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused
    counts = scan_dir.LAUNCHES, scan_fused.LAUNCHES
    scan_dir.mamba_scan_fused_dir = scan_dir.mamba_scan_fused_dir_ref
    scan_fused.mamba_scan_fused = scan_fused.mamba_scan_fused_ref
    try:
        yield
    finally:
        scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused = saved
    if (scan_dir.LAUNCHES, scan_fused.LAUNCHES) != counts:
        raise AssertionError("a kernel launched inside plain_scans()")


def check_close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values out of "
            f"tolerance (rtol {rtol}, atol {atol}); max abs err "
            f"{float(err.max())}")
    return float(err.max())


def scan_inputs(R, L, D, dtype, seed):
    """Inputs in the model's ranges: S4D-like A, dt bias from the model's
    init, unit-normal activations."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cpu_g = torch.Generator().manual_seed(seed)
    rn = lambda *s, sc=1.0: sc * torch.randn(*s, generator=g, device="cuda")
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(D, 1)
    A = (A * torch.exp(0.1 * torch.randn(D, N, generator=cpu_g))).cuda()
    bias = _dt_bias_init((D,), 0.001, 0.1, 1e-4, cpu_g).cuda()
    seq = dict(u=rn(R, L, D), dt=rn(R, L, D, sc=0.5), z=rn(R, L, D),
               acc=rn(R, L, D), B=rn(R, L, N), C=rn(R, L, N))
    seq = {k: v.to(dtype) for k, v in seq.items()}
    return dict(seq, A=A, D=rn(D), bias=bias)


def phase_kernels(results):
    """Kernel vs plain at the main path's shapes; fills ``results``."""
    variants = {
        "dir_reverse": ("scan_dir", dict(reverse=True, gate=False)),
        "dir_gate_acc": ("scan_dir", dict(gate=True, acc=True)),
        "fused_gate": ("scan_fused", {}),
    }
    for shape_name, (R, L, D) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            a = scan_inputs(R, L, D, dtype, seed=L + D)
            rtol, atol = TOL[dtype]
            for vname, (wrapper, flags) in variants.items():
                if wrapper == "scan_dir":
                    kw = dict(reverse=flags.get("reverse", False),
                              gate=flags["gate"],
                              acc=a["acc"] if flags.get("acc") else None)
                    z = a["z"] if flags["gate"] else None
                    args = (a["u"], a["dt"], z, a["A"], a["B"], a["C"],
                            a["D"], a["bias"])
                    kern = lambda s=False: scan_dir.mamba_scan_fused_dir(
                        *args, return_states=s, **kw)
                    plain = lambda s=False: scan_dir.mamba_scan_fused_dir_ref(
                        *args, return_states=s, **kw)
                else:
                    args = (a["u"], a["dt"], a["z"], a["A"], a["B"], a["C"],
                            a["D"], a["bias"])
                    kern = lambda s=False: scan_fused.mamba_scan_fused(
                        *args, return_states=s)
                    plain = lambda s=False: scan_fused.mamba_scan_fused_ref(
                        *args, return_states=s)
                out_k, st_k = kern(True)
                out_p, st_p = plain(True)
                torch.cuda.synchronize()
                tag = f"{vname} {shape_name} {str(dtype)[6:]}"
                err = check_close(f"{tag} out", out_k, out_p, rtol, atol)
                # states are float32 in both dtypes; compared at the f32 tier
                err_st = check_close(f"{tag} states", st_k, st_p,
                                     *TOL[torch.float32])
                reps = 10 if L * D < 1e6 else 5
                ms = cuda_ms(kern, reps)
                plain_ms = cuda_ms(plain, 3)
                log(f"kernel {tag}: max_abs_err {err:.3e} (states "
                    f"{err_st:.3e}), kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms")
                results.append(dict(wrapper=wrapper, variant=vname,
                                    shape=shape_name, dtype=str(dtype)[6:],
                                    max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms))
                del out_k, st_k, out_p, st_p
            del a
            torch.cuda.empty_cache()


def phase_model():
    """Full-width forward: f32 kernel path vs plain scans; bf16 finite."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, *ROI)).astype(np.float32)).cuda()
    model = SegMamba(in_chans=4, out_chans=4,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda").eval()
    with torch.inference_mode():
        y_kernel = model(x)
        with plain_scans():
            y_plain = model(x)
        torch.cuda.synchronize()
        scale = float(y_plain.abs().max())
        err = check_close("f32 forward (kernel vs plain scans)", y_kernel,
                          y_plain, 2e-3, 1e-2 * scale)
        log(f"f32 forward: logits {tuple(y_kernel.shape)}, max|ref| "
            f"{scale:.4f}, max abs err {err:.3e}")
        del y_plain, model
        model_bf = SegMamba(in_chans=4, out_chans=4, dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(0),
                            device="cuda").eval()
        y_bf = model_bf(x)
        torch.cuda.synchronize()
        if y_bf.dtype != torch.float32 or not torch.isfinite(y_bf).all():
            raise AssertionError("bf16 forward: logits not finite float32")
        rel = float((y_bf - y_kernel).abs().max()) / float(
            y_kernel.abs().max())
        ms = cuda_ms(lambda: model_bf(x), 5)
        del model_bf
        model = SegMamba(in_chans=4, out_chans=4,
                         generator=torch.Generator().manual_seed(0),
                         device="cuda").eval()
        ms_f32 = cuda_ms(lambda: model(x), 3)
    log(f"bf16 forward: max |bf16 - f32| / max|f32| = {rel:.4e}; "
        f"{ms:.2f} ms per 128^3 window (median of 5); f32 forward "
        f"{ms_f32:.2f} ms (median of 3)")
    return dict(bf16_rel_dev=rel, ms_per_window=ms)


def phase_case():
    """The bench case's sliding-window inference, counted and timed."""
    rng = np.random.default_rng(0)
    case = np.moveaxis(rng.standard_normal((1, *CASE_SHAPE, 4)), -1, 1)
    case = torch.from_numpy(case.astype(np.float32)).cuda()
    model = SegMamba(in_chans=4, out_chans=4, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda").eval()

    def run():
        return sliding_window_inference(case, ROI, model, overlap=0.5,
                                        sw_batch_size=1,
                                        compute_dtype=torch.bfloat16)

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        scan_dir.LAUNCHES = 0
        scan_fused.LAUNCHES = 0
        out = run()
        torch.cuda.synchronize()
        launches = {"scan_dir": scan_dir.LAUNCHES,
                    "scan_fused": scan_fused.LAUNCHES}
        if launches != {"scan_dir": 128, "scan_fused": 64}:
            raise AssertionError(f"scan launches per case {launches}, "
                                 "expected scan_dir 128, scan_fused 64")
        if out.shape != (1, 4, *CASE_SHAPE) or not torch.isfinite(out).all():
            raise AssertionError(f"case logits: shape {tuple(out.shape)} or "
                                 "non-finite values")
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    log(f"case: logits {tuple(out.shape)}; {sec:.4f} s/case (median of 3: "
        f"{', '.join(f'{t:.4f}' for t in times)}), {1 / sec:.4f} volumes/s;"
        f" peak device memory {peak_gib:.2f} GiB; launches {launches}")
    return launches


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{kind}, count {torch.cuda.device_count()}")
    scan_dir._lib()
    info = _build.BUILD_INFO["gated_scan_fwd"]
    log(f"built gated_scan_fwd in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line.lower():
            log(f"  ptxas: {line.strip()}")
    log(f"phase 1 (device, build): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    results = []
    phase_kernels(results)
    log(f"phase 2 (kernels vs plain): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model_stats = phase_model()
    log(f"phase 3 (full-width forward): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches = phase_case()
    log(f"phase 4 (sliding-window case): {time.perf_counter() - t0:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s; "
        f"ms per window {model_stats['ms_per_window']:.2f}")

    kernels = []
    for wrapper, replaces in REPLACES.items():
        rows = [r for r in results if r["wrapper"] == wrapper]
        main_row = next(r for r in rows if r["shape"] == "stage0"
                        and r["dtype"] == "bfloat16")
        kernels.append(dict(
            name=f"gated_scan_fwd[{wrapper}]", route="cuda", source=SOURCE,
            replaces=replaces, launches=launches[wrapper],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
