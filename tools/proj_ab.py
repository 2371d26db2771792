"""K8's device time on one tree, for an A/B of two trees in one call.

Run from the root of a tree (this repository, or a ``git archive`` of
another commit with this script and ``chip_smoke.py`` copied in) on a
machine with an NVIDIA card:

    python3 tools/proj_ab.py TAG [--ablate] [--probe]

Prints, each line prefixed with ``[TAG]``, for K8 (``scan_proj``) at stage
0 on ``chip_smoke.py`` phase 11's bf16 forward + acc + gate operands (L =
262,144, E = 96, dt_rank 3; ``chip_smoke.proj_call``): the forward call
and the backward call (from the forward's chunk states), each at R = 1
(the inference case's rows) and R = 2 (the train step's):
- the CUDA-event median of 20 lone calls (the wrapper's host work
  included);
- the device time by CUDA-graph replay (median of 20 replays: no host work
  between launches);
- the device time by profile, by kernel name (``chip_smoke.py --breakdown
  proj_fwd`` (R = 2) / ``proj_bwd`` (R = 1), each in a fresh process);
then a stage-0 MambaV3 layer (forward + backward, ``chip_smoke.layer_call``)
under "proj" and "dir2": CUDA-event medians and the device time by kernel
(``--breakdown proj_layer`` / ``dir2_layer``).

With ``--ablate`` (a tree whose K8 runs on the templates): the backward at
stage 0 R = 1 through copies of ``csrc/gated_scan_bwd.cu`` each with one
part of the per-group epilogue dropped (its results are wrong: timing
ablations only), interleaved with the kernel as it is: the channel sums,
the dxc products, the dW terms.

With ``--probe`` (a tree whose K8 runs on the templates): where a block's
time goes, at stage 0 R = 2, from probed copies of
``csrc/gated_scan_fwd.cu`` and ``csrc/gated_scan_bwd.cu`` built into
``segmamba_tpu_torch/_build/`` (the sources themselves unchanged): the
forward's staging phase (the chunk's xc rows, projections and delta), the
rest of sweep 1, the look-back and sweep 2 (clock64 at the phase edges,
the anchors of ``tools/scan_fwd_timeline.py`` plus the staging call, and
inside it the rows' loads, the projections and delta); the
backward's weights, xc tile and projection, sweep F, the look-back's wait,
its fold and publish, and sweep B, of it the groups' channel sums and
epilogue (the global timer, ``tools/scan_bwd_probe.py``'s anchors plus
K8's).
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
from segmamba_tpu_torch.ops import _build, scan_proj  # noqa: E402

ROWS = (1, 2)
LAYERS = ("proj", "dir2")
MAX_BLOCKS = 16384
# the forward: the PROJ staging phase (thread 0's clock64, slot 8 of the
# timeline's 32 per ticket)
_STAGE_CALL = ("    proj_stage_chunk<S, REVERSE, GATE, HAS_ACC>(p, r, d0, t0, "
               "len, bias, sU,\n" + " " * 48 + "sWt, sDtp, sB, sC, sXdt,\n"
               + " " * 48 + "sDel);\n")
# and inside it (clock64 per block, g_split): entry, the rows stored, the
# projections out, delta out
_STAMP = "  if (threadIdx.x == 0) g_split[blockIdx.x * 4 + {}] = clock64();\n"
FWD_PROJ = [
    (_STAGE_CALL, "    const long long c0_ = clock64();\n" + _STAGE_CALL
     + "    STAMP(8, clock64() - c0_)\n"),
    ("namespace {", "__device__ long long g_split[65536 * 4];\nnamespace {"),
    ("  constexpr int AHEAD = 4;", _STAMP.format(0)
     + "  constexpr int AHEAD = 4;"),
    ("  __syncthreads();\n  if constexpr (is_bf16<S>) {\n"
     "    if (p.wmma)   // sWt holds the weights in bfloat16 (proj_stage_wb)\n"
     "      project_rows_mma(sU, p.ldu, 0, len,",
     "  __syncthreads();\n" + _STAMP.format(1) + "  if constexpr "
     "(is_bf16<S>) {\n    if (p.wmma)   // sWt holds the weights in "
     "bfloat16 (proj_stage_wb)\n      project_rows_mma(sU, p.ldu, 0, len,"),
    ("  __syncthreads();\n  switch (p.Rk) {",
     "  __syncthreads();\n" + _STAMP.format(2) + "  switch (p.Rk) {"),
    ("sDel);\n  }\n  __syncthreads();\n}\n",
     "sDel);\n  }\n  __syncthreads();\n" + _STAMP.format(3) + "}\n"),
    ('extern "C" {\n', 'extern "C" {\n'
     "int read_split(long long* h, int n) {\n"
     "  return cudaMemcpyFromSymbol(h, g_split, 4 * 8 * n);\n}\n"),
]
FWD_SPLIT = ("its rows loaded and stored", "the projections", "delta")
FWD_PHASES = ("the chunk's staging and projections", "the rest of sweep 1",
              "look-back", "sweep 2")
_SUMS = ("      proj_group_sums(p.Rk, DB, (int)p.D, nw, sX, sDdt, sDtp, "
         "p.nch, sRed);\n")
_FREE = ("      __syncthreads();   // the exchange and the group's sums are "
         "free\n")
# the backward: slots [0] start, [6] after the tile's projections, [1]
# sweep F's end, [2] the wait's end, [3] sweep B's start, [4] its end, [5]
# the walk's length, [7] the groups' sums and epilogue (accumulated)
BWD_PROBE = [
    ("#include <cuda_runtime.h>\n",
     "#include <cuda_runtime.h>\n"
     f"__device__ unsigned long long g_probe[{MAX_BLOCKS} * 8];\n"),
    ("  const int ng = (len + K - 1) / K;\n",
     "  const int ng = (len + K - 1) / K;\n"
     "  unsigned long long* prb = g_probe + (size_t)ticket * 8;\n"
     "  if (tid == 0) { prb[0] = global_ns(); prb[5] = prb[7] = 0; }\n"),
    ("    __syncthreads();   // the tile's projections are out\n",
     "    __syncthreads();   // the tile's projections are out\n"
     "    if (tid == 0) prb[6] = global_ns();\n"),
    ("  // Look-back: the adjoint entry g",
     "  if (tid == 0) prb[1] = prb[2] = global_ns();\n"
     "  // Look-back: the adjoint entry g"),
    ("    const int jj = (int)sMisc[1];\n",
     "    const int jj = (int)sMisc[1];\n"
     "    if (tid == 0) { prb[2] = global_ns(); prb[5] = jj - w; }\n"),
    ("  // Sweep B: group by group",
     "  if (tid == 0) prb[3] = global_ns();\n  // Sweep B: group by group"),
    (_SUMS, "      const unsigned long long e0_ = global_ns();\n" + _SUMS),
    (_FREE, _FREE + "      if (tid == 0) prb[7] += global_ns() - e0_;\n"),
    ("  if constexpr (PROJ) {   // the block's partials",
     "  if (tid == 0) prb[4] = global_ns();\n"
     "  if constexpr (PROJ) {   // the block's partials"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int probe_read(void* host, long long n) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_probe, n * 8);\n}\n"),
]
BWD_PHASES = ("weights, xc tile and projections", "sweep F",
              "look-back wait", "fold and publish", "sweep B")


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


def probed_lib(name, anchors, entries, tag="proj_probe"):
    """A copy of ``csrc/<name>.cu`` with ``anchors`` ((old, new) text
    edits, each found once), built as ``<name>_<tag>`` and loaded, with the
    wrapper's C signatures of ``entries`` copied from the loaded
    library."""
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in anchors:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new, 1)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}_{tag}.cu"
    so = _build.BUILD_DIR / f"lib{name}_{tag}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    lib = ctypes.CDLL(str(so))
    ref = scan_proj._lib() if "fwd" in name else scan_proj._bwd_lib()
    for fn in entries:
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    return lib


def bwd_call(lib, R):
    """K8's backward at stage 0 on ``chip_smoke.proj_call``'s operands
    through library ``lib`` (the wrapper's ``_run_bwd_kernel``)."""
    L, E, _, rank = cs.STAGE0
    flags = cs.PROJ_CHAIN["forward_acc_gate"]
    a = cs.proj_inputs(R, L, E, rank, torch.bfloat16, seed=L + 6 + R)
    args = [a[k] for k in cs.PROJ_ARGS] + [a["z"], a["acc"]]
    kw = dict(reverse=flags["reverse"], chunk_size=scan_proj.DEF_CHUNK)
    _, st = scan_proj._launch(*args, return_states=True, **kw)
    g = torch.Generator(device="cuda").manual_seed(L + 9)
    dout = torch.randn(R, L, E, generator=g, device="cuda").to(torch.bfloat16)
    return lambda: scan_proj._run_bwd_kernel(
        lib, torch.cuda.current_stream().cuda_stream, *args, dout, st, **kw)


ABLATIONS = {
    "no channel sums": [(_SUMS, "")],
    "no dxc products": [(
        "        v0 = __fmaf_rn(sRed[c * K + qs], wc, v0);\n"
        "        v1 = __fmaf_rn(sRed[c * K + qs + TPC], wc, v1);\n", "")],
    "no dW terms": [("        if (qs + TPC * m < ncol) {\n"
                     "          const float4* rc =",
                     "        if (false) {\n          const float4* rc =")],
}


def ablate(log):
    """The backward's epilogue ablations, interleaved (module note)."""
    entries = ("proj_scan_bwd", "gated_scan_bwd_scratch",
               "proj_scan_bwd_channels", "gated_scan_bwd_error_string")
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        built = {name: pool.submit(probed_lib, "gated_scan_bwd", edits,
                                   entries, tag=f"ablate{k}")
                 for k, (name, edits) in enumerate(ABLATIONS.items())}
        libs = {"as it is": scan_proj._bwd_lib()}
        libs.update({name: f.result() for name, f in built.items()})
    calls = {name: bwd_call(lib, 1) for name, lib in libs.items()}
    ev = {name: [] for name in calls}
    for rep in range(4):   # interleaved, the order flipped each round
        for name in (list(calls) if rep % 2 == 0 else list(calls)[::-1]):
            ev[name].append(cs.cuda_ms(calls[name], 10, warmup=2))
    log("K8 backward ablations, stage0 R=1 bf16, events (median of 4 "
        "rounds): " + "; ".join(f"{name} {statistics.median(ev[name]):.4f} "
                                "ms" for name in calls))


def probe(log):
    """K8's block-time split at stage 0 R = 2 (module note)."""
    import scan_fwd_timeline as ft

    with ThreadPoolExecutor(2) as pool:
        fwd_f = pool.submit(probed_lib, "gated_scan_fwd",
                            ft.PROBES + FWD_PROJ,
                            ("proj_scan_fwd", "gated_scan_fwd_scratch",
                             "gated_scan_error_string"))
        bwd_f = pool.submit(probed_lib, "gated_scan_bwd", BWD_PROBE,
                            ("proj_scan_bwd", "gated_scan_bwd_scratch",
                             "proj_scan_bwd_channels",
                             "gated_scan_bwd_error_string"))
        flib, blib = fwd_f.result(), bwd_f.result()
    flib.read_prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                               ctypes.c_int]
    flib.read_split.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                ctypes.c_int]
    blib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    blib.probe_read.restype = ctypes.c_int
    R = 2
    L, E, _, rank = cs.STAGE0
    flags = cs.PROJ_CHAIN["forward_acc_gate"]
    a = cs.proj_inputs(R, L, E, rank, torch.bfloat16, seed=L + 6 + R)
    args = [a[k] for k in cs.PROJ_ARGS] + [a["z"], a["acc"]]
    kw = dict(reverse=flags["reverse"], chunk_size=scan_proj.DEF_CHUNK)
    stream = torch.cuda.current_stream().cuda_stream
    n = R * -(-L // scan_proj.DEF_CHUNK)   # tickets, one a (row, chunk)
    run = lambda: scan_proj._run_kernel(flib, stream, *args,
                                        return_states=True, **kw)
    run()
    flib.zero_prof()
    _, st = run()
    buf = (ctypes.c_ulonglong * (ft.SLOTS * n))()
    flib.read_prof(buf, n)
    p = np.frombuffer(buf, dtype=np.uint64).reshape(n, ft.SLOTS)
    p = p.astype(np.int64)[R:]   # chunk 0 has no look-back
    ns = p[:, 26] - p[:, 25]
    per_us = (p[:, 7] - p[:, 0]).sum() / ns.sum() * 1e3
    us = [p[:, 8].mean(), (p[:, 1] - p[:, 0] - p[:, 8]).mean(),
          (p[:, 6] - p[:, 1]).mean(), (p[:, 7] - p[:, 6]).mean()]
    sp = np.zeros((n, 4), dtype=np.int64)
    flib.read_split(sp.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n)
    inner = np.diff(sp, axis=1).mean(0) / per_us
    log(f"probe K8 forward stage0 R=2: block {ns.mean() / 1e3:.2f} us; "
        + ", ".join(f"{ph} {c / per_us:.2f}"
                    for ph, c in zip(FWD_PHASES, us))
        + " (of it " + ", ".join(f"{ph} {c:.2f}"
                                  for ph, c in zip(FWD_SPLIT, inner))
        + f"); walk mean {p[:, 27].mean():.2f} chunks (max "
        f"{p[:, 27].max()})")
    g = torch.Generator(device="cuda").manual_seed(L + 9)
    dout = torch.randn(R, L, E, generator=g, device="cuda").to(torch.bfloat16)
    scan_proj._run_bwd_kernel(blib, stream, *args, dout, st, **kw)
    torch.cuda.synchronize()
    buf = np.zeros((MAX_BLOCKS, 8), dtype=np.uint64)
    if blib.probe_read(buf.ctypes.data, buf.size) != 0:
        raise RuntimeError("probe_read failed")
    b = buf[buf[:, 0] > 0].astype(np.int64)
    edges = b[:, [0, 6, 1, 2, 3, 4]]
    us = np.diff(edges, axis=1).mean(0) / 1e3
    span = b[:, 4].max() - b[:, 0].min()
    resident = (b[:, 4] - b[:, 0]).sum() / span
    log(f"probe K8 backward stage0 R=2: {len(b)} blocks, {resident:.1f} "
        f"resident on average; per block {us.sum():.2f} us = "
        + ", ".join(f"{ph} {v:.2f}" for ph, v in zip(BWD_PHASES, us))
        + f" (of it the groups' channel sums and epilogue "
        f"{b[:, 7].mean() / 1e3:.2f}); walk mean {b[:, 5].mean():.1f} "
        f"chunks, max {b[:, 5].max()}")


def main():
    tag, opts = sys.argv[1], sys.argv[2:]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    plain_log = cs.log
    log = cs.log = lambda msg: plain_log(f"[{tag}] {msg}")
    log(f"card: {cs.card_line()}; tree {ROOT}")
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(fn) for fn in (scan_proj._lib,
                                             scan_proj._bwd_lib)]:
            f.result()
    for R in ROWS:
        calls = [cs.proj_call(d, R) for d in ("fwd", "bwd")]
        ev = [cs.cuda_ms(fn, 20, warmup=3) for fn in calls]
        gr = [graph_ms(fn) for fn in calls]
        log(f"K8 stage0 R={R} bf16 forward + acc + gate: forward events "
            f"{ev[0]:.4f} ms, graph replay {gr[0]:.4f} ms; backward events "
            f"{ev[1]:.4f} ms, graph replay {gr[1]:.4f} ms")
        del calls
        torch.cuda.empty_cache()
    for name in ("proj_fwd", "proj_bwd"):
        cs.breakdown_in_child(name, name)
    for comp in LAYERS:
        run = cs.layer_call(comp)
        log(f"stage-0 layer {comp}: forward + backward events "
            f"{cs.cuda_ms(run, 10, warmup=2):.3f} ms")
        del run
        torch.cuda.empty_cache()
        cs.breakdown_in_child(f"{comp}_layer", f"{comp}_layer")
    if "--ablate" in opts:
        ablate(log)
    if "--probe" in opts:
        probe(log)


if __name__ == "__main__":
    main()
