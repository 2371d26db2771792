"""Where the single-pass backward scan's time goes, on the card.

Builds copies of ``segmamba_tpu_torch/csrc/gated_scan_bwd.cu`` into
``segmamba_tpu_torch/_build/`` (each a textual edit; the source itself is
unchanged) and runs the stage-0 backward calls of ``chip_smoke.py`` phase 5
(R=2, L=262,144, D=96, bf16; the three variants) through each, by
``scan_dir._run_bwd_kernel``:

- ``base``: the kernel as it is;
- ``probe``: thread 0 of each block reads the global timer at the phase
  edges (sweep F, the look-back's wait, its fold and publish, sweep B);
  printed per block in microseconds, with the look-back walk's length and
  the mean number of resident blocks;
- ``two_blocks``: the launch bound asks for two blocks an SM, not three
  (more registers, fewer warps);
- ``no_bc_sum``: the dB / dC channel reduce-scatter dropped (its results
  are wrong: a timing ablation only).

Times are CUDA-event medians of lone calls, the variants interleaved.

Run on a machine with an NVIDIA card, from the repository root:
``python3 tools/scan_bwd_probe.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from segmamba_tpu_torch.ops import _build, scan_dir  # noqa: E402

MAX_BLOCKS = 16384
PROBE = [
    ("#include <cuda_runtime.h>\n",
     "#include <cuda_runtime.h>\n"
     f"__device__ unsigned long long g_probe[{MAX_BLOCKS} * 8];\n"),
    ("  const int ng = (len + K - 1) / K;\n",
     "  const int ng = (len + K - 1) / K;\n"
     "  unsigned long long* prb = g_probe + (size_t)ticket * 8;\n"
     "  if (tid == 0) { prb[0] = global_ns(); prb[5] = 0; }\n"),
    ("  // Look-back: the adjoint entry g",
     "  if (tid == 0) prb[1] = prb[2] = global_ns();\n"
     "  // Look-back: the adjoint entry g"),
    ("    const int jj = (int)sMisc[1];\n",
     "    const int jj = (int)sMisc[1];\n"
     "    if (tid == 0) { prb[2] = global_ns(); prb[5] = jj - w; }\n"),
    ("  // Sweep B: group by group",
     "  if (tid == 0) prb[3] = global_ns();\n  // Sweep B: group by group"),
    ("  if (active) {\n    *reinterpret_cast<float4*>(p.dA_p",
     "  if (tid == 0) prb[4] = global_ns();\n"
     "  if (active) {\n    *reinterpret_cast<float4*>(p.dA_p"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int probe_read(void* host, long long n) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_probe, n * 8);\n}\n"),
]
VARIANTS = {
    "base": [],
    "probe": PROBE,
    "two_blocks": [("constexpr int MIN_BLOCKS = 3;",
                    "constexpr int MIN_BLOCKS = 2;")],
    "no_bc_sum": [("      xch[k * 32 + lane] = (h4",
                   "      if (false) xch[k * 32 + lane] = (h4")],
}
PHASES = ("sweep F", "look-back wait", "fold and publish", "sweep B")


def build(name):
    """Compile variant ``name``; returns (name, library, ptxas summary)."""
    src = (_build.CSRC_DIR / "gated_scan_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new, 1)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"gated_scan_bwd_{name}.cu"
    so = _build.BUILD_DIR / f"libgated_scan_bwd_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: {proc.stderr[-3000:]}")
    regs = sorted({int(w.split()[0]) for w in
                   (proc.stdout + proc.stderr).split("Used ")[1:]})
    lib = ctypes.CDLL(str(so))
    ref = scan_dir._bwd_lib()   # the wrapper's signatures, copied
    for fn in ("gated_scan_bwd", "gated_scan_bwd_scratch",
               "gated_scan_bwd_error_string"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    return name, lib, f"registers {regs[0]}-{regs[-1]}"


def probe_split(lib, call, tag):
    """One call through the probed copy: the mean phase times of a block."""
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.probe_read.restype = ctypes.c_int
    call()
    torch.cuda.synchronize()
    buf = np.zeros((MAX_BLOCKS, 8), dtype=np.uint64)
    if lib.probe_read(buf.ctypes.data, buf.size) != 0:
        raise RuntimeError("probe_read failed")
    b = buf[buf[:, 0] > 0].astype(np.int64)
    us = np.diff(b[:, :5], axis=1) / 1e3
    span = b[:, 4].max() - b[:, 0].min()
    resident = (b[:, 4] - b[:, 0]).sum() / span
    print(f"probe {tag}: {len(b)} blocks, {resident:.1f} resident on "
          f"average; per block {us.sum(1).mean():.2f} us = "
          + ", ".join(f"{n} {v:.2f}" for n, v in zip(PHASES, us.mean(0)))
          + f"; walk mean {b[:, 5].mean():.1f} chunks, max {b[:, 5].max()}",
          flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        fwd = pool.submit(scan_dir._lib)
        built = list(pool.map(build, VARIANTS))
        fwd.result()
    for name, _, regs in built:
        print(f"{name}: {regs}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    a, dout = cs.bwd_inputs(*cs.TRAIN_SHAPES["stage0"], torch.bfloat16)
    for vname, (_, flags) in cs.VARIANTS.items():
        gate, reverse = flags.get("gate", True), flags.get("reverse", False)
        args = (a["u"], a["dt"], a["z"] if gate else None,
                a["acc"] if flags.get("acc") else None, a["A"], a["B"],
                a["C"], a["D"], a["bias"])
        kw = dict(reverse=reverse, gate=gate,
                  chunk_size=scan_dir.DEF_CHUNK)
        _, states = scan_dir._launch(*args, return_states=True, **kw)
        calls = {name: (lambda lib=lib: scan_dir._run_bwd_kernel(
            lib, stream, *args, dout, states, **kw))
            for name, lib, _ in built}
        times = {name: [] for name in calls}
        for rep in range(4):   # interleaved, the order flipped each round
            for name in (list(calls) if rep % 2 == 0 else
                         list(calls)[::-1]):
                times[name].append(cs.cuda_ms(calls[name], 5))
        print(f"stage 0 {vname} (ms, best round of 4 medians): "
              + ", ".join(f"{n} {min(t):.4f}" for n, t in times.items()),
              flush=True)
        probe_split(dict((n, lib) for n, lib, _ in built)["probe"],
                    calls["probe"], vname)
        del calls, states


if __name__ == "__main__":
    main()
