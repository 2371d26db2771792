"""The training side of one tree, for an A/B of two trees in one call.

Run from the root of a tree (this repository, or a ``git archive`` of
another commit with this script and ``chip_smoke.py`` copied in) on a
machine with an NVIDIA card:

    python3 tools/scan_bwd_ab.py TAG [--full]

Prints, each line prefixed with ``[TAG]``:
- the train step of ``chip_smoke.py`` phase 7 (s/step, peak memory,
  device time by kernel class, the per-module split);
- a dir2 stage-0 and stage-1 Mamba layer run alone (phase 13's measure);
- the backward scan kernel alone at the four stage shapes (bf16, phase 5's
  inputs, the three variants): CUDA-event medians of 30 lone calls, and the
  device time of the same call replayed from a CUDA graph (no host work
  between launches; median of 20 replays), with the sum per train step;
- with ``--full``: K5's backward at stage 0 (R = 2, bf16) and K6's at the
  LM prefill shape, then every ``--breakdown bwd_*`` (device time by
  kernel name, each in a fresh process).

The backward scan class of the step's profile also counts the three
kernels of the backward before PR 10 (``bwd_chunk``, ``bwd_carry``,
``bwd_grad``), so the script reads a tree of either design.
"""

from __future__ import annotations

import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from segmamba_tpu_torch.ops import scan_dir  # noqa: E402

OLD_BWD = ("bwd_chunk_kernel", "bwd_carry_kernel", "bwd_grad_kernel")


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


def stage_times(log):
    shapes = {**cs.TRAIN_SHAPES, **cs.TIME_SHAPES}
    events, graphs = {}, {}
    for st in cs.STAGES:
        R, L, D = shapes[st]
        a, dout = cs.bwd_inputs(R, L, D, torch.bfloat16)
        for v in cs.VARIANTS:
            kern = cs.bwd_kernel_call(v, a, dout)
            events[v, st] = cs.cuda_ms(kern, 30, warmup=3)
            graphs[v, st] = graph_ms(kern)
            del kern
        log(f"bwd kernel {st} {(R, L, D)} bf16 ("
            + " / ".join(cs.VARIANTS) + "): events "
            + " / ".join(f"{events[v, st]:.4f}" for v in cs.VARIANTS)
            + " ms, graph replay "
            + " / ".join(f"{graphs[v, st]:.4f}" for v in cs.VARIANTS)
            + " ms")
        del a, dout
        torch.cuda.empty_cache()
    per_step = lambda t: cs.LAYERS_PER_STAGE * sum(t.values())
    log(f"backward scans per train step: events {per_step(events):.4f} ms, "
        f"graph replay {per_step(graphs):.4f} ms")


def main():
    tag, full = sys.argv[1], "--full" in sys.argv[2:]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    plain_log = cs.log
    log = cs.log = lambda msg: plain_log(f"[{tag}] {msg}")
    cs.KERNEL_CLASSES = tuple(
        (c, subs + OLD_BWD) if c.startswith("scan backward") else (c, subs)
        for c, subs in cs.KERNEL_CLASSES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {cs.card_line()}; tree {os.getcwd()}")
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(fn) for fn in (scan_dir._lib,
                                             scan_dir._bwd_lib)]:
            f.result()
    cs.phase_train()
    image = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, *cs.ROI)).astype(np.float32)).cuda()
    model = cs.build_composition("dir2", torch.bfloat16, remat="convs")
    rows = cs.module_split(model, image, ["vit.stages.0.0",
                                          "vit.stages.1.0"])
    log("dir2 layers alone: " + ", ".join(
        f"{n} fwd {f:.3f} ms bwd {b:.3f} ms" for n, f, b in rows))
    del model, image
    torch.cuda.empty_cache()
    stage_times(log)
    if not full:
        return
    k5 = cs.slice_bwd_call(2, cs.SLICE_SHAPES["stage0"], torch.bfloat16)
    log(f"K5 bwd stage0 R=2 bf16: events {cs.cuda_ms(k5, 10):.4f} ms")
    del k5
    k6 = cs.core_bwd_call(*cs.CORE_SHAPES["prefill"])
    log(f"K6 bwd prefill f32: events {cs.cuda_ms(k6, 10):.4f} ms")
    del k6
    torch.cuda.empty_cache()
    for name in ("bwd_dir_reverse", "bwd_dir_gate_acc", "bwd_fused_gate",
                 "bwd_slice", "bwd_core"):
        cs.breakdown_in_child(name, name)


if __name__ == "__main__":
    main()
