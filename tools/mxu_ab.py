"""K7's device time on one tree, for an A/B of two trees in one call.

Run from the root of a tree (this repository, or a ``git archive`` of
another commit with this script and ``chip_smoke.py`` copied in) on a
machine with an NVIDIA card:

    python3 tools/mxu_ab.py TAG [--probe]

Prints, each line prefixed with ``[TAG]``, for K7 (``scan_mxu``) and for
K6 (``scan_core``) on the same inputs (``chip_smoke.py`` phase 14's
"model" kind, float32, 16 states, at the LM prefill shape R=2, L=2048,
D=5120 and at stage 0 R=2, L=262,144, D=96), the forward call and the
backward call (from the forward's chunk states):
- the CUDA-event median of 20 lone calls (the wrapper's host work
  included);
- the device time by CUDA-graph replay (median of 20 replays: no host work
  between launches);
- the device time by profile, by kernel name (``chip_smoke.py --breakdown
  {mxu|k6}_{fwd|bwd}[_prefill]``, each in a fresh process).

With ``--probe`` (a tree whose K7 runs on the templates): where a block's
time goes, at stage 0 R=2, from probed copies of
``csrc/gated_scan_fwd.cu`` and ``csrc/gated_scan_bwd.cu`` built into
``segmamba_tpu_torch/_build/`` with the anchors of
``tools/scan_fwd_timeline.py`` and ``tools/scan_bwd_probe.py`` (the
sources themselves unchanged): the forward's phases (sweep 1, look-back,
sweep 2) in microseconds per block, and the backward's (sweep F,
look-back wait, fold and publish, sweep B).
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.getcwd()
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
from segmamba_tpu_torch.ops import _build, scan_core, scan_mxu  # noqa: E402

SHAPES = ("prefill", "stage0_r2")


def graph_ms(fn, reps=20):
    """Median ms of ``fn`` replayed from a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(shape):
    """Phase 14's "model" operands, dy and dlast at ``shape``; (T, S)."""
    R, L, D = cs.MXU_SHAPES[shape]
    u, delta, A, B, C = cs.mxu_inputs(R, L, D, "model", seed=L + D + R)
    g = torch.Generator(device="cuda").manual_seed(L + 1)
    dy = torch.randn(R, L, D, generator=g, device="cuda")
    dlast = torch.randn(R, D, cs.N, generator=g, device="cuda")
    return (u, delta, A, B, C, dy, dlast), scan_mxu._geometry(L)


def calls(ops, geom):
    """{name: (forward, backward)} of K7 and K6 on the same operands."""
    u, delta, A, B, C, dy, dlast = ops
    T, S = geom
    st = scan_mxu._launch(u, delta, A, B, C, T, S, True)[1]
    out = {"K7": (lambda: scan_mxu._launch(u, delta, A, B, C, T, S, True),
                  lambda: scan_mxu._launch_bwd(u, delta, A, B, C, dy, dlast,
                                               st, T, S, True))}
    Tc = scan_core.DEF_CHUNK
    st6 = scan_core._launch(u, delta, A, B, C, Tc)[1]
    out["K6"] = (lambda: scan_core._launch(u, delta, A, B, C, Tc),
                 lambda: scan_core._launch_bwd(u, delta, A, B, C, dy, dlast,
                                               st6, Tc))
    return out


def probed_lib(name, anchors, entry):
    """A probed copy of ``csrc/<name>.cu`` (``anchors``: (old, new) text
    edits, each found once), built and loaded, with the wrapper's C
    signatures of ``entry`` and the scratch sizer copied."""
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in anchors:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new, 1)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}_mxu_probe.cu"
    so = _build.BUILD_DIR / f"lib{name}_mxu_probe.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    lib = ctypes.CDLL(str(so))
    ref = scan_mxu._lib() if "fwd" in name else scan_mxu._bwd_lib()
    for fn in (entry, f"{name}_scratch"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    err = ("gated_scan_error_string" if "fwd" in name
           else "gated_scan_bwd_error_string")
    getattr(lib, err).argtypes = [ctypes.c_int]
    getattr(lib, err).restype = ctypes.c_char_p
    return lib


def probe(log):
    """K7's block-time split at stage 0 R=2 (module note)."""
    import scan_bwd_probe as bp
    import scan_fwd_timeline as ft

    with ThreadPoolExecutor(2) as pool:
        fwd_f = pool.submit(probed_lib, "gated_scan_fwd", ft.PROBES,
                            "mxu_scan_fwd")
        bwd_f = pool.submit(probed_lib, "gated_scan_bwd", bp.PROBE,
                            "mxu_scan_bwd")
        flib, blib = fwd_f.result(), bwd_f.result()
    flib.read_prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                               ctypes.c_int]
    ops, (T, S) = operands("stage0_r2")
    u, delta, A, B, C, dy, dlast = ops
    R, L, D = cs.MXU_SHAPES["stage0_r2"]
    stream = torch.cuda.current_stream().cuda_stream
    n = R * -(-L // T)            # tickets (one channel block of 96)
    run = lambda: scan_mxu._run_kernel(flib, stream, u, delta, A, B, C, T, S,
                                       True)
    run()
    flib.zero_prof()
    y, st = run()
    buf = (ctypes.c_ulonglong * (ft.SLOTS * n))()
    flib.read_prof(buf, n)
    p = np.frombuffer(buf, dtype=np.uint64).reshape(n, ft.SLOTS)
    p = p.astype(np.int64)[R:]   # chunk 0 has no look-back
    cycles = np.diff(p[:, 0:8], axis=1).mean(0)
    ns = p[:, 26] - p[:, 25]
    per_us = (p[:, 7] - p[:, 0]).sum() / ns.sum() * 1e3
    walk = p[:, 27]
    log(f"probe K7 forward stage0_r2: block {ns.mean() / 1e3:.2f} us; "
        + ", ".join(f"{ph} {c / per_us:.2f}"
                    for ph, c in zip(ft.PHASES, cycles))
        + f"; walk mean {walk.mean():.2f} chunks (max {walk.max()})")
    bp.probe_split(blib, lambda: scan_mxu._run_bwd_kernel(
        blib, stream, u, delta, A, B, C, dy, dlast.transpose(1, 2)
        .contiguous(), st, T, S, True), "K7 backward stage0_r2")


def main():
    tag, with_probe = sys.argv[1], "--probe" in sys.argv[2:]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    plain_log = cs.log
    log = cs.log = lambda msg: plain_log(f"[{tag}] {msg}")
    log(f"card: {cs.card_line()}; tree {ROOT}")
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(fn) for fn in (scan_mxu._lib,
                                             scan_mxu._bwd_lib)]:
            f.result()
    for shape in SHAPES:
        ops, geom = operands(shape)
        for name, (fwd, bwd) in calls(ops, geom).items():
            ev = [cs.cuda_ms(fn, 20, warmup=3) for fn in (fwd, bwd)]
            gr = [graph_ms(fn) for fn in (fwd, bwd)]
            log(f"{name} {shape} {cs.MXU_SHAPES[shape]}: forward events "
                f"{ev[0]:.4f} ms, graph replay {gr[0]:.4f} ms; backward "
                f"events {ev[1]:.4f} ms, graph replay {gr[1]:.4f} ms")
        del ops
        torch.cuda.empty_cache()
    for kern in ("mxu", "k6"):
        for direction in ("fwd", "bwd"):
            for suffix in ("", "_prefill"):
                name = f"{kern}_{direction}{suffix}"
                cs.breakdown_in_child(name, name)
    if with_probe:
        probe(log)


if __name__ == "__main__":
    main()
