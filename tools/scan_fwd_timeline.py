"""Per-block timeline of the single-pass forward scan on the card.

Builds an instrumented copy of ``segmamba_tpu_torch/csrc/gated_scan_fwd.cu``
(probes inserted as text, the source itself unchanged) into
``segmamba_tpu_torch/_build/``, runs the stage-0 ``dir_reverse`` and
``fused_gate`` calls of ``chip_smoke.py`` phase 2 (R=1, L=262,144, D=96,
bf16) once through it, and prints, averaged over the blocks: the phases of
a block (sweep 1 with its staging, the look-back's parts, sweep 2 with the
outputs) in microseconds, and the look-back walk's length in chunks.
Thread 0 of each block reads ``clock64`` at the phase edges and the global
timer at the ends; the cycle rate comes from the two.

Run on a machine with an NVIDIA card, from the repository root:
``python3 tools/scan_fwd_timeline.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from segmamba_tpu_torch.ops import _build, scan_dir, scan_fused  # noqa: E402

SLOTS = 32
PROBES = [
    ("namespace {",
     "__device__ unsigned long long g_prof[32 * 65536];\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "#define PROBE(i) if (threadIdx.x == 0 && ticket < 65536) "
     "g_prof[32 * ticket + (i)] = clock64();\n"
     "#define STAMP(i, v) if (threadIdx.x == 0 && ticket < 65536) "
     "g_prof[32 * ticket + (i)] = (v);\n"
     "namespace {"),
    ("  const unsigned ticket = sMisc[0];\n",
     "  const unsigned ticket = sMisc[0];\n  PROBE(0) STAMP(25, gtimer())\n"),
    ("  // Look-back: the entry state x of chunk w.",
     "  PROBE(1)\n  // Look-back: the entry state x of chunk w."),
    ("    publish(flags + w, FLAG_AGG);\n",
     "    publish(flags + w, FLAG_AGG);\n    PROBE(2)\n"),
    ("    const int j = (int)sMisc[1];\n",
     "    const int j = (int)sMisc[1];\n    PROBE(3) STAMP(27, w - 1 - j)\n"),
    ("      unpack(__ldcg(in), __ldcg(in + 1), x);\n",
     "      unpack(__ldcg(in), __ldcg(in + 1), x);\n"
     "      STAMP(4, clock64() + (x[0] != x[0]))\n"),
    ("  if (w < p.nc - 1) {   // publish the inclusive state of w\n",
     "  PROBE(5)\n  if (w < p.nc - 1) {   // publish the inclusive state of w\n"),
    ("  if (!active) return;   // no barrier follows\n",
     "  PROBE(6)\n  if (!active) return;   // no barrier follows\n"),
    ("  if (p.states != nullptr) {\n    float* st = p.states + ((r * p.nc + w)",
     "  PROBE(7) STAMP(26, gtimer())\n"
     "  if (p.states != nullptr) {\n    float* st = p.states + ((r * p.nc + w)"),
    ('extern "C" {',
     'extern "C" {\n'
     "int read_prof(unsigned long long* h, int n) {\n"
     "  cudaDeviceSynchronize();\n"
     "  return cudaMemcpyFromSymbol(h, g_prof, 32 * 8 * n);\n}\n"
     "int zero_prof() {\n"
     "  static unsigned long long z[32 * 65536];\n"
     "  return cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n"),
]
PHASES = ["sweep 1 (with staging)", "aggregate out", "walk",
          "inclusive load", "fold", "inclusive out", "sweep 2 (with outputs)"]


def build():
    src = (_build.CSRC_DIR / "gated_scan_fwd.cu").read_text()
    for old, new in PROBES:
        if src.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once: {old!r}")
        src = src.replace(old, new, 1)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "gated_scan_fwd_timeline.cu"
    so = _build.BUILD_DIR / "libgated_scan_fwd_timeline.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    lib = ctypes.CDLL(str(so))
    ref = scan_dir._lib()   # the wrapper's signatures, copied
    for name in ("gated_scan_fwd", "gated_scan_fwd_scratch",
                 "gated_scan_error_string"):
        getattr(lib, name).argtypes = getattr(ref, name).argtypes
        getattr(lib, name).restype = getattr(ref, name).restype
    lib.read_prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                              ctypes.c_int]
    return lib


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    lib = build()
    a = cs.scan_inputs(1, 262144, 96, torch.bfloat16, seed=262144 + 96)
    args = (a["u"], a["dt"], a["z"], a["A"], a["B"], a["C"], a["D"],
            a["bias"])
    calls = {
        "dir_reverse": lambda: scan_dir.mamba_scan_fused_dir(
            args[0], args[1], None, *args[3:], reverse=True, gate=False),
        "fused_gate": lambda: scan_fused.mamba_scan_fused(*args),
    }
    real = scan_dir._lib()
    nc = 2048
    for name, fn in calls.items():
        fn()
        lib.zero_prof()
        scan_dir._LIB = lib
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            scan_dir._LIB = real
        buf = (ctypes.c_ulonglong * (SLOTS * nc))()
        lib.read_prof(buf, nc)
        p = np.frombuffer(buf, dtype=np.uint64).reshape(nc, SLOTS)
        p = p.astype(np.int64)[1:]   # chunk 0 has no look-back
        cycles = np.diff(p[:, 0:8], axis=1).mean(0)
        ns = p[:, 26] - p[:, 25]
        per_us = (p[:, 7] - p[:, 0]).sum() / ns.sum() * 1e3
        walk = p[:, 27]
        print(f"{name}: block {ns.mean() / 1e3:.2f} us; "
              + ", ".join(f"{n} {c / per_us:.2f}"
                          for n, c in zip(PHASES, cycles))
              + f"; walk mean {walk.mean():.2f} chunks (p50 "
              f"{np.median(walk):.0f}, p90 {np.percentile(walk, 90):.0f}, "
              f"max {walk.max()})", flush=True)


if __name__ == "__main__":
    main()
