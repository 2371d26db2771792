"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path (``segmamba_tpu_torch``) through the entry
points a user calls, at the full width of the BraTS SegMamba, and checks it.
Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), a CUDA card
   required, the forward scan kernel built from ``segmamba_tpu_torch/csrc``.
1b. The backward scan kernel (``gated_scan_bwd.cu``; with the forward
   one they also hold the ratio-form scan K7, ``mxu_fwd_kernel`` and
   ``mxu_bwd_kernel``, and the projection-fused scan K8,
   ``proj_fwd_kernel`` and ``proj_bwd_kernel``), the 3x3x3 conv K9
   (``conv3d_k3s1_fwd.cu``, ``conv3d_k3s1_dw.cu``) and the scan probes
   K10 (``scan_lb_fwd.cu``) and K11 (``scan_flat_fwd.cu``), built in
   parallel with the forward one (one nvcc each, from six threads): build
   times, ptxas registers/spills.
2. Kernel vs plain PyTorch at the main path's shapes (stage 0: R=1,
   L=262144, D=96; stage 3: R=1, L=512, D=768; N=16) for the three flag
   sets the path launches (dir reverse ungated, dir gate + acc, fused gate
   with shared params) plus the chunk exit states; float32 at rtol 6e-4 /
   atol 2e-3, bfloat16 I/O compared in float32 at rtol 3e-2 / atol 5e-2.
   Times by CUDA events, median of several runs; the bf16 stage-0
   ``dir_reverse`` and ``fused_gate`` calls also split by kernel name
   under torch.profiler (``breakdown_in_child``: the single-pass kernel and
   the zero fill of its flags), each profile the only session of a fresh
   process; a profile that records no device kernel twice is written as
   not measured.
3. Full-width SegMamba forward on 1x4x128^3 (random weights, seed 0):
   float32 kernel path vs the same model on the plain scans (rtol 2e-3,
   atol 1e-2 * max|ref|); bfloat16 logits finite, their deviation from
   float32 and the ms per window.
4. The bench case's sliding-window inference (150x180x150x4 from
   numpy.random.default_rng(0), roi 128^3, overlap 0.5, gaussian, sw_batch
   1, bfloat16): one warm-up, then timed runs; logits finite; the scan
   launch counters must rise by exactly 128 (scan_dir) and 64 (scan_fused)
   per case (8 windows x 8 Mamba layers x 2 and x 1).
5. Backward kernels vs the plain backward (autograd through the plain
   forward, float32) at the train step's stage-0 (R=2, L=262144, D=96) and
   stage-3 (R=2, L=512, D=768) shapes, three flag sets, all nine
   gradients; float32 at 6e-4 / 2e-3, bfloat16 at 3e-2 / 5e-2 (compared in
   float32). The reduced gradients (dA, dD, dbias: sums over all steps and
   rows; dB, dC: sums over channels) use the absolute tolerance scaled by
   max(1, max|plain|), since the two sides sum in different orders. Both
   sides run, and are timed, at the full length. The plain backward runs
   over channel slices in turn (channels are independent in the scan), as
   few as keep each slice's predicted peak (bytes per element measured at
   stage 3) under 3/4 of the card's free memory: one at stage 3, two at
   stage 0. A CUDA forward with inputs that require grad must have a
   grad_fn, and its backward must count. The backward kernel alone is
   also timed (bf16) at stages 1 (R=2, L=32768, D=192) and 2 (R=2,
   L=4096, D=384), and the sum per train step logged (2 layers a stage,
   each one call of every variant); the bf16 stage-0 calls are split by
   kernel name as phase 2's are (``--breakdown bwd_<variant>``).
6. Full-width SegMamba, float32, 1x4x64^3: the parameter gradients of the
   kernel path against the plain-scan path. All of them together within
   1e-3 relative L2 (two plain compositions of the same math, dir2 and
   per-direction, differ by 4.5e-5 at 32^3 on the CPU); each parameter within rtol 2e-3 and atol 5e-2 of the
   larger of its own max |grad| and 1e-3 of the model's. The per-parameter
   bound is a wiring check (a lost or wrong gradient is off by 100%): the
   scans agree to ~1e-6 (phase 5), but the deepest blocks' instance norms
   amplify that, and two plain compositions of the same math (dir2,
   per-direction) already differ there by up to 3% of a parameter's max.
7. The train step at the recipe shape: batch 2 x 4 x 128^3 from
   numpy.random.default_rng(0), bfloat16 model with float32 parameters,
   remat="convs", SGD (clip 12, wd 3e-5, nesterov 0.99) with poly LR, CE
   on random labels. One warm-up step, then 5 timed steps (host clock after
   torch.cuda.synchronize()); the loss is finite every step and falls;
   scan launches per step exactly 16 + 8 forward and 16 + 8 backward. Peak
   memory; one more step under torch.profiler, its device time by kernel
   class and the device's idle share of the step; and the forward/backward
   time of each top-level module run alone on the inputs it saw. The same
   step with the device augmentation chain (``train_step(augment=...)``,
   the trainer's draws): one warm-up, 5 steps timed alone with exactly
   the bare step's scan launches each, then 6 with the trainer's prefetch
   thread pinning and copying host batches meanwhile.
8. The trainer end to end: ``segmamba_tpu_torch.train`` on six synthetic
   4 x 144^3 cases in a temporary directory, 1 epoch x 4 steps with
   validation on 2 patches, then ``--resume`` with 2 epochs: it continues
   at the saved epoch 0 and step 4, as the JAX trainer does, and ends at
   epoch 1, step 12; checkpoints must exist. First the
   recipe's host augmentation chain (the native resampler) is timed on two
   2 x 4 x 128^3 batches in this process: it takes seconds a batch, so
   the trainer runs with ``--augmentation noaug`` (2 loader processes)
   and with ``--augmentation device`` (the chain on the card inside the
   step), each with its resume; step p50 and data-wait max of each run.
   The chain's arrays are held against the JAX package's by the CPU tests.
   The on-device chain (``data/augment_device.py``) on a raw 2 x 4 x 128^3
   sampler batch: CUDA events, median of 5 after a warm-up, over five
   default draws and with every coin forced to fire; the host's time to
   draw a batch's parameters; and one all-firing sample on the card
   against the port's CPU run of the same parameters and noise field
   (images at rtol 1e-4 / atol 1e-4 x max|cpu|, labels equal except where
   the CPU's warped seg lies within 1e-4 of a half-integer).
9. K6 (``scan_core``, the templates' ``softplus=False`` mode) vs its plain
   version at the LM prefill's shape (R=2, L=2048, D=5120, N=16) and a
   ragged one (R=1, L=2000): forward y, chunk states and last state at the
   float32 tier 6e-4 / 2e-3; backward through ``selective_scan_kernel``
   (grad_fn present, one backward launch) with a nonzero gradient of the
   last state, all five gradients, the reduced ones (dA, dB, dC: sums over
   steps or channels) with the absolute tolerance scaled by
   max(1, max|plain|). Times by CUDA events, and the bound; the prefill
   backward also split by kernel name (``--breakdown bwd_core``). Then K6
   at N = 4 and N = 64 (ceil(N / 16) launches of 16 states each way) vs its
   plain version at R=1, L=2048, D=1024, forward and backward.
10. The Mamba LM serving path at the width of ``state-spaces/mamba-2.8b``
   (its published config.json: d_model 2560, 64 layers, vocab 50277 padded
   to 50280, RMSNorm, residual in float32, d_state 16, d_conv 4, expand 2),
   random weights from seed 0 built on the card, after the SegMamba phases'
   memory is freed; float32 matmuls without TF32:
   a. float32 prefill of a 512-token prompt at batch 2 through K6 and
      through the plain scans: last-position logits within 1e-3 relative L2,
      every layer's SSM cache within rtol 2e-3 / atol 2e-3 x its max|plain|
      (64 layers of float32 residual stream and RMSNorm amplify the scans'
      ~1e-6 differences unevenly; an element-wise bound on the logits would
      be set by the few that grow most, so the logits are held as a whole,
      and each cache against its own scale); exactly 64 K6 launches;
   b. the float32 full forward ``model(ids)``: exactly 64 K2 launches, no
      K6, its last-position logits within 1e-3 relative L2 of (a)'s;
   c. a gradient through the prefill (a loss on the logits and every
      layer's last state, the embedding trainable): exactly 64 K6 backward
      launches, finite gradients;
   d. bfloat16 serving (float32 parameters): ``generate`` on a 2048-token
      prompt, batch 1, 128 greedy new tokens, a short warm-up (2
      tokens), median of 3: prefill ms (``generate`` of one token), decode
      ms per token, new tokens per second, peak memory; tokens in range,
      logits finite; the
      generate run launches 64 K6 and no other scan kernel (decoding
      launches none);
   e. ``from_pretrained`` on a tiny snapshot written to a temporary
      directory loads strictly and gives the saved model's logits.
   The same model with ``scan_impl="mxu"`` (the ratio-form scan K7): the
   f32 prefill of (a) within 1e-3 relative L2 of K6's logits, exactly 64
   K7 and no other scan launch, and the full forward likewise (64 K7); the
   gradient of (c) with 64 K7 backward launches, its embedding gradient
   within 1e-3 relative L2 of K6's; the bf16 ``generate`` prefill of (d)
   timed beside K6's (64 K7); the ratio-form share of each prefill.

11. K5 (the slice-order scan, ``scan_dir.mamba_scan_fused_slice``) and K8
   (the projection-fused scan, ``scan_proj.mamba_scan_proj``) vs their
   plain versions at stage 0 (L=262144, d_inner 96, S=64, dt_rank 3):
   K5 forward at R=1 and 2 beside the interleave-copy form it replaces
   (K2 on interleaved copies, de-interleaved), K5 backward at R=1 and 2
   with the plain backward over channel slices as in phase 5, both also
   at stage 3's shape (L=512, d_inner 768 over several channel blocks,
   S=8); K8 forward at R=2 in the three flag sets of the "proj" chain
   (slice ungated, reverse + acc, forward + acc + gate) and at R=1 (the
   case's rows) in the last, K8 backward at R=1 (its plain backward
   cannot be split by channel: its peak is measured at L=16384 and the
   full length must fit the card first). float32 and bfloat16 at the
   phase-2/5 tiers; times, plain times and bounds; the backward's bf16
   forward + acc + gate call also timed at R=2 (the train step's rows);
   K5's stage-0 R=2 bf16 backward and K8's bf16 calls (forward R=2,
   backward R=1) also split by kernel name (``--breakdown bwd_slice``,
   ``proj_fwd``, ``proj_bwd``).
12. The compositions at full width, built by
   ``Config(model=ModelConfig(scan_impl=...)).build_model()`` with the
   same seed-0 weights: "dir2", "dir", "dir" with ``slice_kernel=True``
   set on every MambaV3 (K5), "proj" (K8 at stage 0, K1/K2 deeper) and
   "mxu" (per direction, K7 in each: 8 Mamba layers x 3 = 24 per window,
   counted from the model; the ratio-form share of the window):
   the float32 window's logits vs dir2's (rtol 2e-4, atol 1e-4 x
   max|dir2|; the compositions rearrange one computation, and on an
   H100 they differ by 4.3e-6 to 4.6e-6 at a max|dir2| of 5.2), the
   bfloat16 window's relative L2 vs dir2's (<= 1.5e-2; 7.0e-3 there), exact
   launch counts per window and per bench case, ms per
   window and s/case (median of 3), each in turn.
13. The recipe train step (phase 7's) under the same five compositions in
   turn: s/step (median of 4 after a warm-up), peak memory, losses
   finite and falling over 5 steps, exact forward and backward launches
   per step; the forward and backward ms of a stage-0 and a stage-1
   Mamba layer run alone; then the device time of a stage-0 layer's
   forward + backward by kernel name under "mxu" and "dir2"
   (``--breakdown mxu_layer`` / ``dir2_layer``): K7's kernels against the
   per-direction glue (flips, float32 casts, D-skip and gate); and under
   "proj" (``proj_layer``): K8's two kernels against the rest.
14. K7 (``scan_mxu``) vs its plain version at the LM prefill's shape
   (R=2, L=2048, D=5120), a ragged one (R=1, L=2000) and SegMamba's stage
   0 (R=1 and 2, L=262144, D=96), N=16, on four kinds of input: deltas in
   the model's range, every unit tripped (delta + 40), a mix (delta + 2 on
   every third chunk) and "spiked" (delta + 40 on every third chunk);
   forward y, chunk states and last state, and all five gradients with a
   nonzero gradient of the last state, at the float32 tier 6e-4 / 2e-3
   (dA, dB, dC with the absolute part scaled by max(1, max|plain|)); the
   plain versions over channel slices that keep their predicted peak under
   3/4 of the free memory. On "spiked" the references are float64 runs of
   the plain versions, and K6 (forward and backward) is held there too,
   every output but ddelta; ddelta's share of the tier is printed for the
   kernels and the plain float32 versions (``ddelta_report``: float32
   cannot meet the tier there), with the share of the tier each kernel
   uses on the rest. The ratio-form share
   of each input (``scan_mxu.tally``), K7's times beside K6's on the same
   inputs (CUDA events), the plain times and K6's bound (``core_bound``:
   K7 computes K6's function on K6's operands); the device time of one K7
   call each way on the "model" input at stage 0 R=2 and at the prefill
   shape (``--breakdown mxu_fwd``, ``mxu_bwd``, ``mxu_fwd_prefill``,
   ``mxu_bwd_prefill``).

15. K9 (``segmamba_tpu_torch.ops.conv3d``, the channels-last 3x3x3 SAME
   conv and its weight gradient): forward, dx and dw through
   ``conv3d_k3s1``'s autograd Function vs the plain versions at ragged
   shapes (Cin 4 / 48 / 96 / 192, H and W that no tile divides, B = 2),
   float32 and bfloat16 (y and dx at the dtype's tier, dw at the f32
   tier with the absolute part scaled by max(1, max|plain|)); the main
   path, ``conv3d_k3s1`` forward and backward once at each of
   ``benchmarks/bench_conv.py``'s six shapes (128^3 48->48, 96->48, 4->48;
   64^3 96->96, 192->96; 32^3 192->192; bf16, batch 1), with the counters
   read around it (two forward-kernel launches, y and dx, and one dw
   launch per shape); then per shape the kernel's forward and dw ms, its
   forward + backward ms, the plain versions' ms and cuDNN's
   (``F.conv3d`` on channels_last_3d views and
   ``torch.nn.grad.conv3d_weight``, ``cudnn.benchmark`` on), CUDA events,
   median of 5, beside the bounds (``conv_bound``), each kernel's ratio to
   cuDNN and share of its bound; the device time of one call of each
   kernel and of cuDNN's two calls per shape (torch.profiler, one session
   in a fresh process, the calls cut apart by marker kernels:
   ``conv_device_in_child``); then the twin of ``benchmarks/bench_conv.py``
   (``segmamba_tpu_torch.benchmarks.bench_conv``), its ``main`` at its
   defaults with the counters read around it: 3 (1 + 3 k) forward-kernel
   and 1 + 3 k dw launches per shape.
16. ``MambaV3(d_state=4)`` and ``(d_state=32)`` at d_model 48 on 1 x
   32768 tokens (32 slices) under dir2, dir, dir + K5, fused and proj:
   forward and backward through the kernels (ceil(N / 16) launches per
   scan call each way, counted exactly) against the same module on the
   plain scans, output and every parameter gradient at the f32 tier (the
   gradients' absolute part scaled by max(1, max|plain|)); forward +
   backward ms.
17. The scan probes, through the benchmark twins
   ``segmamba_tpu_torch.benchmarks.bench_scan_lb`` (K10, ``variant_call``:
   "noshift" and "nohs") and ``bench_scan_flat`` (K11, ``flat_call``), at
   the JAX scripts' shape (L = 262,144, D = 96, N = 16; R = 1, and R = 3
   for K11): each against its plain version (serial carry) in float32 at
   6e-4 / 2e-3 and bfloat16 at 3e-2 / 5e-2, compared in float32, the
   plain versions over channel slices that keep their predicted peak
   under 3/4 of the free memory; K11 against K2's kernel on the same
   inputs at the same tiers; exactly one launch per call. bf16 times by
   CUDA events, median of 5, beside K2's on the same inputs, the bounds
   (``probe_bound``) and the plain versions (one run); device time by
   kernel name (torch.profiler, each in a fresh process:
   ``breakdown_in_child``) for K10, K11 and K2 at R = 1, and the K2
   - K10("nohs") gap. Then both twins' ``main()`` at their defaults, the
   counters set to 0 before and read after: exactly 19 launches of each
   K10 variant, 40 of K11 and 59 of K2.
18. Whole-volume inference and the case pipeline (``infer/whole_volume.py``,
   ``deploy.py``, ``compute_metrics.py``), full-width SegMamba, seed 0:
   K1/K2 vs plain (phase 2's variants and tiers) at the whole-volume stage
   shapes of the bench case padded to 160x192x160 (stage 0: R=1, L=614400,
   D=96; stage 3: L=1200, D=768, a ragged last chunk); the float32
   ``whole_volume_inference`` on a 155x240x240 brain phantom (a seeded
   ellipsoid of nonzero voxels in a zero frame, z-scored inside; its box
   rounds to 144x176x144) with kernels vs the same model on the plain
   scans (rtol 2e-3, atol 1e-2 * max|ref|, as phase 3); bf16 times (host
   clock after synchronize, median of 3 after a warm-up) and peak memory
   of ``whole_volume_inference`` on the bench case (no crop), on the
   phantom (crop) and on the uncropped frame (``crop_to_nonzero=False``,
   160x240x240 padded), and ``whole_volume_tta`` over axes (0, 1, 2) on the
   bench case; every call: exactly 16 K1 and 8 K2 launches a forward,
   finite logits of the frame's shape, class 0 at 20.0 outside the box.
   Then ``SegmentationAlgorithm`` on one raw phantom case written as four
   NIfTI modalities and a seg (sliding window, roi 128^3, sw_batch 1,
   mirror TTA over 3 axes, bf16; weights from a checkpoint): n_windows x 8
   x 16 K1 and x 8 K2 launches, a NIfTI of the frame's shape with labels
   in {0..3}; ``compute_metrics`` on it against the seg (finite); the
   case's seconds by step (preprocessing, device prediction, inverse +
   write).
19. Parallelism (``segmamba_tpu_torch.parallel``, ``ops/scan_sharded.py``)
   through the local launcher (``parallel.multihost.launch``), phase 7's
   model and batch (bf16, remat "convs", seed 0). First K6 forward and
   backward at the sequence-parallel shard shapes (2 ranks, R = 2: L =
   131,072 / 16,384 / 2,048 / 256 at D = 96 / 192 / 384 / 768, float32):
   CUDA events and bounds, at stage 0 also against the plain versions
   (ddelta, where the float32 versions differ beyond the tier, against a
   float64 run on those channels: within the tier or within 4x the plain
   float32 version's share of it, phase 14's rule);
   and the fix-up (``scan_sharded.fixup``) forward + backward at each,
   summed per SP step. Then, in this process, the references (every
   step cudnn deterministic): the plain train step twice (its run-to-run
   spread), the "mxu" composition's step (two compositions of one
   computation: the rounding a bf16 step carries), the split step (the
   plain step on each sample alone, gradients averaged: DP's arithmetic
   without its collective), the float32 plain step on a 2 x 4 x 64^3
   batch and a float32 stage-0 MambaV3 (d_model 48, L = 262,144, 64
   slices, batch 2) forward and backward.
   a. A world of 1 over NCCL on cuda:0: ``train_step(mesh=)`` equals the
      plain step within the plain step's own run-to-run spread (0 when it
      is deterministic); 16 / 8 / 16 / 8 dir2 launches.
   b. A world of 2 over gloo with both ranks on cuda:0 (NCCL refuses two
      ranks on one device; gloo is named here only): the SP step (("data",
      "seq") of (1, 2): 24 K6 launches each way a step and rank, no
      other scan), the DP step (("data",) of 2, one sample a rank) and the
      TP step (("model",) of 2, dir2 at d_inner / 2: 16 / 8 / 16 / 8),
      each held on rank 0 against the plain batch-2 step: loss and
      gradient norm at rtol 3e-2, every parameter gradient elementwise at
      rtol 3e-2 / atol 5e-2 x the larger of its max |grad| and 1e-3 of the
      model's (the instance-norm-fed biases against the model's max) or
      within twice the mxu
      composition's distance on it, all together within the larger of
      3e-2 and twice the mxu composition's relative L2; the DP step
      within 1e-4 relative L2 of the split step; the same three steps in
      float32 on the 64^3 batch against the float32 plain step (DP
      against the float32 split step), where rounding is small and a
      gradient's wrong scope is not: every parameter at rtol 2e-3 / atol
      1e-2 x its scale, all within 1e-3 relative L2 (no mxu clause); the
      parameters (under TP those outside the shards) bit-equal on both
      ranks after the checked step and a timed one (s/step, host clock
      after synchronize: two ranks sharing one H100, not a scaling
      number; the host seconds, calls and bytes of its collectives);
      each rank's peak GiB over the timed step; an SP forward (one
      window) launches 24 K6.
   c. In the same world, the float32 stage-0 MambaV3 under SP 2 against
      the unsharded layer (dir2): output and input gradient at 6e-4 /
      2e-3, the parameter gradients with the absolute part scaled by
      max(1, max|ref|), each tensor's error printed beside its max;
      3 K6 launches each way.

Times: kernels by CUDA events, median of several runs after a warm-up;
the plain versions one run each, right after the run their check made.
Breakdowns by kernel name run in fresh processes that a phase starts
together; they import in parallel and take the card one at a time under a
file lock (``breakdowns_in_children``).

Bounds (``bound_of``): the largest of the bytes over the HBM rate, the
float32 operations over 67 TFLOP/s, the transcendental results over the
SFU rate (16 per clock per SM x the SMs x the max SM clock from
nvidia-smi) and the bf16 tensor-core operations over 989 TFLOP/s; the
JSON line names the unit in ``bound_unit`` and "bytes" or "operations"
in ``bound_by``.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import fcntl
import functools
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from segmamba_tpu_torch.benchmarks import (
    bench_conv,
    bench_scan_flat,
    bench_scan_lb,
)
from segmamba_tpu_torch.config import Config, ModelConfig
from segmamba_tpu_torch.data import (
    MedicalDataset,
    PatchSampler,
    augment_device,
    get_train_transforms,
)
from segmamba_tpu_torch import compute_metrics
from segmamba_tpu_torch.data.nifti import read_nifti
from segmamba_tpu_torch.data.preprocessing import (
    bbox_from_mask,
    create_nonzero_mask,
)
from segmamba_tpu_torch.data.synthetic import (
    MODALITIES,
    phantom_case,
    write_raw_phantom_case,
    write_synthetic_cases,
)
from segmamba_tpu_torch.deploy import SegmentationAlgorithm
from segmamba_tpu_torch.infer import (
    nonzero_bbox,
    sliding_window_inference,
    whole_volume_inference,
    whole_volume_tta,
)
from segmamba_tpu_torch.infer.sliding_window import _scan_starts
from segmamba_tpu_torch.models import MambaLMHeadModel, MambaV3, SegMamba
from segmamba_tpu_torch.models.mamba import _dt_bias_init
from segmamba_tpu_torch.models.segmamba import _call
from segmamba_tpu_torch.ops import (
    _build,
    conv3d,
    scan_core,
    scan_dir,
    scan_fused,
    scan_mxu,
    scan_proj,
    scan_sharded,
)
from segmamba_tpu_torch.parallel.mesh import make_mesh, shard_batch
from segmamba_tpu_torch.parallel.multihost import launch
from segmamba_tpu_torch.parallel.tp import tp_gather_state
from segmamba_tpu_torch.train import poly_schedule
from segmamba_tpu_torch.train.__main__ import main as train_main
from segmamba_tpu_torch.train.losses import cross_entropy_loss
from segmamba_tpu_torch.train.train_state import (
    apply_gradients,
    create_train_state,
    train_step,
)
from segmamba_tpu_torch.train.trainer import _prefetch
from segmamba_tpu_torch.utils.hf import from_pretrained

SOURCES = {"fwd": "segmamba_tpu_torch/csrc/gated_scan_fwd.cu",
           "bwd": "segmamba_tpu_torch/csrc/gated_scan_bwd.cu"}
REPLACES = {
    "scan_dir": "segmamba_tpu/ops/scan_pallas_dir.py:60",
    "scan_fused": "segmamba_tpu/ops/scan_pallas_fused.py:42",
}
BWD_REPLACES = {
    "scan_dir": "segmamba_tpu/ops/scan_pallas_dir.py:119",
    "scan_fused": "segmamba_tpu/ops/scan_pallas_fused.py:73",
}
SHAPES = {"stage0": (1, 262144, 96), "stage3": (1, 512, 768)}
TRAIN_SHAPES = {"stage3": (2, 512, 768), "stage0": (2, 262144, 96)}
# phase 5: the backward kernel alone (bf16) at the other two stages too
TIME_SHAPES = {"stage1": (2, 32768, 192), "stage2": (2, 4096, 384)}
STAGES = ("stage0", "stage1", "stage2", "stage3")
LAYERS_PER_STAGE = 2          # SegMamba depths 2/2/2/2: per layer one call
                              # of each variant (dir2: 2 K3 + 1 K4)
GRADS = ("du", "ddt", "dz", "dacc", "dA", "dB", "dC", "dD", "dbias")
REDUCED = ("dA", "dB", "dC", "dD", "dbias")
PLAIN_BWD_SHARE = 0.75        # of the card's free memory, per plain slice
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # float32 outside the tensor cores (data sheet)
BF16_TC_FLOP_PER_S = 989e12   # bf16 on the tensor cores, dense (data sheet)
SFU_PER_CLOCK_PER_SM = 16     # transcendental results (ex2, lg2, rcp)
_SFU_RATE = []                # results/s, read once by sfu_rate()
# phase 2: the calls whose device time is also split by kernel name, each
# with its name for ``breakdown_call``
BREAKDOWN_TAGS = {"dir_reverse stage0 bfloat16": "dir_reverse",
                  "fused_gate stage0 bfloat16": "fused_gate"}
VARIANTS = {
    "dir_reverse": ("scan_dir", dict(reverse=True, gate=False)),
    "dir_gate_acc": ("scan_dir", dict(gate=True, acc=True)),
    "fused_gate": ("scan_fused", {}),
}
N = 16
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
CASE_SHAPE = (150, 180, 150)
ROI = (128, 128, 128)
GRAD_SHAPE = (64, 64, 64)          # phase 6
TRAINER_CASE = (144, 144, 144)     # phase 8
DEVICE = "cuda"                    # phases 9 and 10
CORE_SHAPES = {"prefill": (2, 2048, 5120), "ragged": (1, 2000, 5120)}
CORE_REPLACES = {"fwd": "segmamba_tpu/ops/scan_pallas.py:162",
                 "bwd": "segmamba_tpu/ops/scan_pallas.py:194"}
CORE_GRADS = ("du", "ddelta", "dA", "dB", "dC")
CORE_N_SHAPE = (1, 2048, 1024)     # phase 9: K6 at N != 16 (state groups)
SLICE_REPLACES = {"fwd": "segmamba_tpu/ops/scan_pallas_dir.py:477",
                  "bwd": "segmamba_tpu/ops/scan_pallas_dir.py:514"}
PROJ_REPLACES = {"fwd": "segmamba_tpu/ops/scan_pallas_proj.py:71",
                 "bwd": "segmamba_tpu/ops/scan_pallas_proj.py:134"}
STAGE0 = (262144, 96, 64, 3)       # L, d_inner, nslices, dt_rank
PROJ_CHAIN = {                     # K8's flag sets on the "proj" chain
    "slice": dict(z=False, acc=False, reverse=False),
    "reverse_acc": dict(z=False, acc=True, reverse=True),
    "forward_acc_gate": dict(z=True, acc=True, reverse=False),
}
COMPOSITIONS = ("dir2", "dir", "dir_slice", "proj", "mxu")   # 12 and 13
PROJ_PLAIN_SHARE = 0.85            # of free memory, the plain K8 backward
LM_CONFIG = dict(vocab_size=50277, d_model=2560, n_layer=64, rms_norm=True,
                 pad_vocab_size_multiple=8)   # state-spaces/mamba-2.8b
LM_CHECK = (2, 512)                # batch, prompt: float32 kernel vs plain
LM_SERVE = (1, 2048, 128)          # batch, prompt, new tokens: bf16 serving
MXU_REPLACES = {"fwd": "segmamba_tpu/ops/scan_pallas_mxu.py:131",
                "bwd": "segmamba_tpu/ops/scan_pallas_mxu.py:165"}
MXU_SHAPES = {"prefill": (2, 2048, 5120), "ragged": (1, 2000, 5120),
              "stage0_r1": (1, 262144, 96), "stage0_r2": (2, 262144, 96)}
MXU_KINDS = ("model", "tripped", "mixed", "spiked")            # phase 14
# peak bytes per (row, step, channel, state) of K7's plain forward and
# backward (float32; "64": float64; "k6_": K6's plain version): first
# guesses, replaced by phase 14's measurements
MXU_PLAIN_BPE = {"fwd": 96.0, "bwd": 256.0, "fwd64": 400.0, "bwd64": 1200.0,
                 "k6_fwd64": 400.0, "k6_bwd64": 1600.0, "k6_bwd": 800.0}
# phase 14 "spiked": each kernel's ddelta share of the f32 tier against
# float64 is held to this multiple of the plain float32 version's share
# (readings on an H100 80GB HBM3 at 700 W: kernel / plain 0.97-2.28 for K6,
# 1.90-2.93 for K7)
DDELTA_PLAIN_MULT = 4.0
CONV_SOURCES = {"fwd": "segmamba_tpu_torch/csrc/conv3d_k3s1_fwd.cu",
                "dw": "segmamba_tpu_torch/csrc/conv3d_k3s1_dw.cu"}
CONV_REPLACES = {"fwd": "segmamba_tpu/ops/conv3d_pallas.py:59",
                 "dw": "segmamba_tpu/ops/conv3d_pallas.py:152"}
# phase 15: benchmarks/bench_conv.py's shapes (spatial, Cin, Cout), bf16,
# batch 1; the first is the JSON line's row
CONV_SHAPES = ((128, 48, 48), (128, 96, 48), (128, 4, 48), (64, 96, 96),
               (64, 192, 96), (32, 192, 192))
CONV_CHECKS = ((2, 5, 7, 9, 4, 6), (1, 6, 10, 12, 48, 48),
               (1, 5, 9, 11, 96, 48), (1, 4, 6, 10, 192, 192))
GROUP_D_STATES = (4, 32)                       # phase 16
GROUP_COMPOSITIONS = {   # scan launches per MambaV3 call and state group
    "dir2": ("dir2", False, dict(scan_dir=2, scan_fused=1)),
    "dir": ("dir", False, dict(scan_dir=2, scan_fused=1)),
    "dir_slice": ("dir", True, dict(scan_dir=2, scan_dir_slice=1)),
    "fused": ("fused", False, dict(scan_fused=1)),
    "proj": ("proj", False, dict(scan_proj=3)),
}
GROUP_SHAPE = (1, 32768, 48, 32)               # batch, L, d_model, nslices
PROBE_SOURCES = {"noshift": "segmamba_tpu_torch/csrc/scan_lb_fwd.cu",
                 "nohs": "segmamba_tpu_torch/csrc/scan_lb_fwd.cu",
                 "flat": "segmamba_tpu_torch/csrc/scan_flat_fwd.cu"}
PROBE_REPLACES = {"noshift": "benchmarks/bench_scan_lb.py:26",
                  "nohs": "benchmarks/bench_scan_lb.py:26",
                  "flat": "benchmarks/bench_scan_flat.py:42"}
PROBE_NAMES = {"noshift": "K10", "nohs": "K10", "flat": "K11"}
PROBE_SHAPE = (262144, 96)         # phase 17: L, D of the scripts' mains
PROBE_FLAT_ROWS = (1, 3)           # bench_scan_flat.py's batches
PROBE_CASES = (("noshift", 1), ("nohs", 1)) + tuple(
    ("flat", R) for R in PROBE_FLAT_ROWS)
# phase 18: K1/K2 at the whole-volume stage shapes of the bench case padded
# to 160x192x160 (stage 0: 80 x 96 x 80 tokens; stage 3: 10 x 12 x 10)
WV_SHAPES = {"wv_stage0": (1, 614400, 96), "wv_stage3": (1, 1200, 768)}
BRATS_FRAME = (155, 240, 240)      # the uncropped BraTS frame (z, y, x)
WV_PER_FORWARD = dict(scan_dir=16, scan_fused=8)
GPU_LOCK_ENV = "CHIP_SMOKE_GPU_LOCK"   # breakdown children's card lock
WV_RUNS = ("wholevol_bench", "wholevol_phantom", "wholevol_uncropped",
           "wholevol_tta_bench")


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
    names = ((scan_dir, "mamba_scan_fused_dir"),
             (scan_dir, "mamba_scan_fused_slice"),
             (scan_fused, "mamba_scan_fused"), (scan_proj, "mamba_scan_proj"))
    saved = [getattr(mod, n) for mod, n in names]
    counts = launch_counts()
    for mod, n in names:
        setattr(mod, n, getattr(mod, f"{n}_ref"))
    try:
        yield
    finally:
        for (mod, n), fn in zip(names, saved):
            setattr(mod, n, fn)
    if launch_counts() != counts:
        raise AssertionError("a kernel launched inside plain_scans()")


def launch_counts():
    return {"scan_dir": scan_dir.LAUNCHES, "scan_fused": scan_fused.LAUNCHES,
            "scan_dir_bwd": scan_dir.BWD_LAUNCHES,
            "scan_fused_bwd": scan_fused.BWD_LAUNCHES,
            "scan_core": scan_core.LAUNCHES,
            "scan_core_bwd": scan_core.BWD_LAUNCHES,
            "scan_dir_slice": scan_dir.SLICE_LAUNCHES,
            "scan_dir_slice_bwd": scan_dir.SLICE_BWD_LAUNCHES,
            "scan_proj": scan_proj.LAUNCHES,
            "scan_proj_bwd": scan_proj.BWD_LAUNCHES,
            "scan_mxu": scan_mxu.LAUNCHES,
            "scan_mxu_bwd": scan_mxu.BWD_LAUNCHES,
            "conv3d": conv3d.LAUNCHES, "conv3d_dw": conv3d.DW_LAUNCHES,
            **probe_counts()}


def expected_counts(**nonzero):
    """Every counter 0 but the ones named."""
    return {**dict.fromkeys(launch_counts(), 0), **nonzero}


def reset_counts():
    for mod in (scan_dir, scan_fused, scan_core, scan_proj, scan_mxu):
        mod.LAUNCHES = mod.BWD_LAUNCHES = 0
    scan_dir.SLICE_LAUNCHES = scan_dir.SLICE_BWD_LAUNCHES = 0
    conv3d.LAUNCHES = conv3d.DW_LAUNCHES = 0
    bench_scan_lb.LAUNCHES = bench_scan_flat.LAUNCHES = 0
    bench_scan_lb.VARIANT_LAUNCHES.update(
        dict.fromkeys(bench_scan_lb.VARIANTS, 0))


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


def variant_calls(vname, a):
    """Phase 2's kernel and plain calls of variant ``vname`` on ``a``'s
    operands; each takes ``return_states`` (default False)."""
    wrapper, flags = VARIANTS[vname]
    if wrapper == "scan_dir":
        kw = dict(reverse=flags.get("reverse", False), gate=flags["gate"],
                  acc=a["acc"] if flags.get("acc") else None)
        z = a["z"] if flags["gate"] else None
        args = (a["u"], a["dt"], z, a["A"], a["B"], a["C"], a["D"],
                a["bias"])
        kern = lambda s=False: scan_dir.mamba_scan_fused_dir(
            *args, return_states=s, **kw)
        plain = lambda s=False: scan_dir.mamba_scan_fused_dir_ref(
            *args, return_states=s, **kw)
    else:
        args = (a["u"], a["dt"], a["z"], a["A"], a["B"], a["C"], a["D"],
                a["bias"])
        kern = lambda s=False: scan_fused.mamba_scan_fused(
            *args, return_states=s)
        plain = lambda s=False: scan_fused.mamba_scan_fused_ref(
            *args, return_states=s)
    return kern, plain


def phase_kernels(results, shapes=SHAPES):
    """Kernel vs plain at the main path's shapes; fills ``results``."""
    pending = []                  # (row, breakdown job)
    for shape_name, (R, L, D) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            a = scan_inputs(R, L, D, dtype, seed=L + D)
            rtol, atol = TOL[dtype]
            for vname, (wrapper, _) in VARIANTS.items():
                kern, plain = variant_calls(vname, a)
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
                plain_ms = cuda_ms(plain, 1, warmup=0)
                log(f"kernel {tag}: max_abs_err {err:.3e} (states "
                    f"{err_st:.3e}), kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms")
                row = dict(wrapper=wrapper, variant=vname, shape=shape_name,
                           dtype=str(dtype)[6:], max_abs_err=err, ms=ms,
                           plain_ms=plain_ms)
                if tag in BREAKDOWN_TAGS:
                    pending.append((row, (BREAKDOWN_TAGS[tag], tag)))
                results.append(row)
                del out_k, st_k, out_p, st_p
            del a
            torch.cuda.empty_cache()
    for (row, _), parts in zip(pending, breakdowns_in_children(
            [job for _, job in pending])):
        row["breakdown"] = parts


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
        reset_counts()
        out = run()
        torch.cuda.synchronize()
        launches = launch_counts()
        if launches != expected_counts(scan_dir=128, scan_fused=64):
            raise AssertionError(f"scan launches per case {launches}, "
                                 "expected scan_dir 128, scan_fused 64 and "
                                 "no backward")
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


def sfu_rate():
    """Transcendental results per second: 16 per clock per SM (the SFU's
    ex2 / lg2 / rcp rate on Hopper) x the SM count x the card's max SM
    clock (``nvidia-smi --query-gpu=clocks.max.sm``); read once."""
    if not _SFU_RATE:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _SFU_RATE.append(SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6)
        log(f"SFU rate: {SFU_PER_CLOCK_PER_SM} x {sms} SMs x {mhz:.0f} MHz "
            f"= {_SFU_RATE[0]:.4e} results/s")
    return _SFU_RATE[0]


def bound_of(nbytes, f32_ops, sfu, tc_ops=0.0):
    """Least time (ms) of a call and the unit that bounds it: the largest
    of its bytes over the HBM rate ("bytes"), its float32 operations over
    the f32 rate ("fp32"), its transcendental results over the SFU rate
    ("sfu") and its bf16 tensor-core operations over their rate
    ("tensor"); the units run side by side. The JSON line names "bytes"
    or "operations" (``bound_kind``)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "fp32": f32_ops / F32_FLOP_PER_S, "sfu": sfu / sfu_rate(),
             "tensor": tc_ops / BF16_TC_FLOP_PER_S}
    unit = max(terms, key=terms.get)
    return terms[unit] * 1e3, unit


def bound_kind(unit):
    return "bytes" if unit == "bytes" else "operations"


def scan_bound(direction, variant, R, L, D, dtype):
    """Least time (ms) of one scan call at these shapes, and what bounds
    it (``bound_of``): the bytes the function must move (each input read
    once, each output written once), its float32 operations and its
    transcendental results. Float32 operations per (step, channel, state):
    forward 7 (delta A, a x, delta u B and the add, C x and its add);
    backward 24 (those 7 to recompute x, then g = C dy + g, a g, dp = g x
    a, dA += dp delta, ddelta += dp A, S += g B, and the dB and dC
    products and sums); per (step, channel) 14 more (softplus, D-skip,
    gate and its derivative, sigmoid, beside their exps). Transcendental
    results: one exp per (step, channel, state) either way (the backward
    needs exp(delta A) once per step), plus softplus's and, gated, the
    gate's exp per (step, channel)."""
    es = 2 if dtype == torch.bfloat16 else 4
    seq, bc = R * L * D, R * L * N
    gate, acc = variant != "dir_reverse", variant == "dir_gate_acc"
    params = (D * N + 2 * D) * 4
    if direction == "fwd":
        nbytes = (2 + gate + acc + 1) * seq * es + 2 * bc * es + params
        ops = seq * (7 * N + 14)
    else:
        states = R * -(-L // 128) * N * D * 4
        nbytes = ((3 + gate + acc) + (2 + gate + acc)) * seq * es \
            + 4 * bc * es + states + 2 * params
        ops = seq * (24 * N + 14)
    return bound_of(nbytes, ops, seq * (N + 1 + gate))


def grad_check(tag, got, want, dtype):
    """Hold the nine gradients against the plain backward; returns the
    largest absolute error."""
    rtol, atol = TOL[dtype]
    worst = 0.0
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            if g is not None:
                raise AssertionError(f"{tag} {name}: unexpected gradient")
            continue
        a = atol * max(1.0, float(w.abs().max())) if name in REDUCED \
            else atol
        worst = max(worst, check_close(f"{tag} {name}", g, w, rtol, a))
    return worst


def plain_bwd_sliced(seq, params, dout, *, gate, reverse, width,
                     nslices=0):
    """The plain backward (dir, or with ``nslices`` the slice-order scan)
    over channel slices of ``width``, run in turn. The scan's channels are
    independent: du, ddt, dz, dacc, dA, dD and dbias are the slices'
    results side by side, and dB, dC (sums over channels) are the sums of
    the slices' results."""
    dim = seq["u"].shape[-1]
    parts = []
    for d0 in range(0, dim, width):
        sl = slice(d0, d0 + width)

        def ch(t):
            return None if t is None else t[..., sl]

        parts.append(scan_dir._plain_bwd(
            ch(seq["u"]), ch(seq["dt"]), ch(seq["z"]), ch(seq["acc"]),
            params[0][sl], seq["B"], seq["C"], params[1][sl], params[2][sl],
            ch(dout), gate=gate, reverse=reverse,
            chunk_size=scan_dir.DEF_CHUNK, nslices=nslices))
    out = []
    for name, gs in zip(GRADS, zip(*parts)):
        if gs[0] is None:
            out.append(None)
        elif name in ("dB", "dC"):
            out.append(torch.stack(gs).sum(0))
        else:   # the channel axis: last for sequences, first for A, D, bias
            out.append(torch.cat(gs, dim=0 if name in REDUCED else -1))
    return tuple(out)


def bwd_inputs(R, L, D, dtype):
    """Phase 5's operands at (R, L, D) and its output gradient."""
    a = scan_inputs(R, L, D, dtype, seed=L + D + 1)
    g = torch.Generator(device="cuda").manual_seed(L)
    return a, torch.randn(R, L, D, generator=g, device="cuda").to(dtype)


def bwd_kernel_call(vname, a, dout):
    """The backward kernel of variant ``vname`` alone on ``a``'s operands:
    one forward launch for the chunk exit states, then a closure that
    launches ``scan_dir._launch_bwd`` (not counted)."""
    flags = VARIANTS[vname][1]
    gate, reverse = flags.get("gate", True), flags.get("reverse", False)
    z = a["z"] if gate else None
    acc = a["acc"] if flags.get("acc") else None
    args = (a["u"], a["dt"], z, acc, a["A"], a["B"], a["C"], a["D"],
            a["bias"])
    kw = dict(reverse=reverse, gate=gate, chunk_size=scan_dir.DEF_CHUNK)
    _, states = scan_dir._launch(*args, return_states=True, **kw)
    return lambda: scan_dir._launch_bwd(*args, dout, states, **kw)


def phase_backward(results):
    """Backward kernels vs the plain backward at the train step's shapes,
    then the kernel alone (bf16) at stages 1 and 2 and the sum per train
    step; fills ``results``. Returns (the plain backward's bytes per
    element at stage 3, {variant: {stage: bf16 kernel ms}})."""
    bytes_per_elem = None
    stage_ms = {v: {} for v in VARIANTS}
    pending = []                  # (row, breakdown job)
    for shape_name, (R, L, D) in TRAIN_SHAPES.items():
        width = D
        if bytes_per_elem is not None:
            torch.cuda.empty_cache()
            budget = PLAIN_BWD_SHARE * torch.cuda.mem_get_info()[0]
            slices = math.ceil(bytes_per_elem * R * L * D * N / budget)
            width = math.ceil(D / slices)
        for dtype in (torch.float32, torch.bfloat16):
            a, dout = bwd_inputs(R, L, D, dtype)
            for vname, (wrapper, flags) in VARIANTS.items():
                gate = flags.get("gate", True)
                reverse = flags.get("reverse", False)
                seq = {k: a[k] for k in ("u", "dt", "B", "C")}
                seq["z"] = a["z"] if gate else None
                seq["acc"] = a["acc"] if flags.get("acc") else None
                params = (a["A"], a["D"], a["bias"])

                # kernel side through the wrapper and its autograd Function
                leaves = {k: (None if v is None else
                              v.detach().requires_grad_())
                          for k, v in seq.items()}
                pleaves = [p.detach().requires_grad_() for p in params]
                mod = scan_dir if wrapper == "scan_dir" else scan_fused
                before = mod.BWD_LAUNCHES
                if wrapper == "scan_dir":
                    out = scan_dir.mamba_scan_fused_dir(
                        leaves["u"], leaves["dt"], leaves["z"], pleaves[0],
                        leaves["B"], leaves["C"], pleaves[1], pleaves[2],
                        acc=leaves["acc"], gate=gate, reverse=reverse)
                else:
                    out = scan_fused.mamba_scan_fused(
                        leaves["u"], leaves["dt"], leaves["z"], pleaves[0],
                        leaves["B"], leaves["C"], pleaves[1], pleaves[2])
                if out.grad_fn is None:
                    raise AssertionError(f"{vname}: CUDA forward with "
                                         "requires_grad inputs has no "
                                         "grad_fn")
                out.backward(dout)
                if mod.BWD_LAUNCHES != before + 1:
                    raise AssertionError(f"{vname}: backward kernel launches "
                                         f"{mod.BWD_LAUNCHES - before}")
                order = ("u", "dt", "z", "acc")
                got = [None if leaves[k] is None else leaves[k].grad
                       for k in order]
                got = got + [pleaves[0].grad, leaves["B"].grad,
                             leaves["C"].grad, pleaves[1].grad,
                             pleaves[2].grad]
                del out, leaves, pleaves

                def plain():
                    return plain_bwd_sliced(seq, params, dout, gate=gate,
                                            reverse=reverse, width=width)

                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                want = plain()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                if shape_name == "stage3":
                    bytes_per_elem = max(bytes_per_elem or 0.0,
                                         peak / (R * L * D * N))
                tag = f"bwd {vname} {shape_name} {str(dtype)[6:]}"
                err = grad_check(tag, got, want, dtype)
                del got, want

                # the kernel alone at the full length
                kern = bwd_kernel_call(vname, a, dout)
                ms = cuda_ms(kern, 5 if L * D > 1e6 else 10)
                plain_ms = cuda_ms(plain, 1, warmup=0)
                bound, bound_by = scan_bound("bwd", vname, R, L, D, dtype)
                log(f"kernel {tag}: max_abs_err {err:.3e}, kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms (channel slices "
                    f"of {width} of {D} in turn, peak {peak / 2 ** 30:.2f} "
                    f"GiB), bound {bound:.4f} ms ({bound_by})")
                row = dict(wrapper=wrapper, variant=vname, shape=shape_name,
                           dtype=str(dtype)[6:], max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by)
                if dtype == torch.bfloat16:
                    stage_ms[vname][shape_name] = ms
                del kern
                torch.cuda.empty_cache()
                if dtype == torch.bfloat16 and shape_name == "stage0":
                    pending.append((row, (f"bwd_{vname}", tag)))
                results.append(row)
            del a, dout
            torch.cuda.empty_cache()
        if shape_name == "stage3":
            log(f"plain backward: {bytes_per_elem:.1f} bytes of peak memory "
                "per (row, step, channel, state) at stage 3")
    for (row, _), parts in zip(pending, breakdowns_in_children(
            [job for _, job in pending])):
        row["breakdown"] = parts
        row["device_ms"] = None if parts is None else sum(parts.values())
    for shape_name, (R, L, D) in TIME_SHAPES.items():
        a, dout = bwd_inputs(R, L, D, torch.bfloat16)
        for vname in VARIANTS:
            kern = bwd_kernel_call(vname, a, dout)
            stage_ms[vname][shape_name] = ms = cuda_ms(kern, 10)
            bound, bound_by = scan_bound("bwd", vname, R, L, D,
                                         torch.bfloat16)
            log(f"kernel bwd {vname} {shape_name} bfloat16 {(R, L, D)}: "
                f"kernel {ms:.4f} ms (alone), bound {bound:.4f} ms "
                f"({bound_by})")
            del kern
        del a, dout
        torch.cuda.empty_cache()
    per_stage = {st: LAYERS_PER_STAGE * sum(stage_ms[v][st] for v in VARIANTS)
                 for st in STAGES}
    log("backward scans per train step (bf16, events of lone calls; "
        f"{LAYERS_PER_STAGE} layers x (" + " + ".join(VARIANTS) + ") per "
        "stage): " + ", ".join(f"{st} {ms:.4f} ms" for st, ms in
                               per_stage.items())
        + f"; sum {sum(per_stage.values()):.4f} ms")
    return bytes_per_elem, stage_ms


def param_grads(model, x, labels):
    model.zero_grad(set_to_none=True)
    cross_entropy_loss(model(x), labels).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def phase_grads():
    """Full-width f32 parameter gradients: kernel path vs plain scans."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, *GRAD_SHAPE)).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 4, (1, *GRAD_SHAPE))).cuda()
    model = SegMamba(in_chans=4, out_chans=4,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda")
    reset_counts()
    got = param_grads(model, x, labels)
    counts = launch_counts()
    if counts != expected_counts(scan_dir=16, scan_fused=8, scan_dir_bwd=16,
                                 scan_fused_bwd=8):
        raise AssertionError(f"full-width backward launches {counts}")
    with plain_scans():
        want = param_grads(model, x, labels)
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-3 * top)
        err = check_close(f"grad {k}", got[k], w, 2e-3, 5e-2 * scale)
        worst = max(worst, err / scale)
    rel_l2 = (sum(float((got[k] - w).double().square().sum())
                  for k, w in want.items())
              / sum(float(w.double().square().sum())
                    for w in want.values())) ** 0.5
    if not rel_l2 <= 1e-3:
        raise AssertionError(f"full-width gradients: relative L2 {rel_l2}")
    log(f"full-width f32 gradients: {len(want)} parameters, max |grad| "
        f"{top:.4e}, relative L2 {rel_l2:.3e}, worst max-abs-err / scale "
        f"{worst:.3e}")
    del model, got, want
    torch.cuda.empty_cache()


KERNEL_CLASSES = (   # (class, substrings of the kernel name), first match wins
    ("scan K7 backward (gated_scan_bwd RATIO)", ("mxu_bwd_kernel",)),
    ("scan K7 forward (gated_scan_fwd RATIO)", ("mxu_fwd_kernel",)),
    ("scan K8 backward (gated_scan_bwd PROJ)", ("proj_bwd_kernel",)),
    ("scan K8 forward (gated_scan_fwd PROJ)", ("proj_fwd_kernel",)),
    ("scan backward (gated_scan_bwd)", ("scan_bwd_kernel",)),
    ("scan forward (gated_scan_fwd)", ("scan_fwd_kernel",)),
    ("cuDNN convolution (incl. layout transforms)",
     ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit", "nchwtonhwc",
      "nhwctonchw")),
    ("cuBLAS matmul", ("gemm", "cutlass")),
    ("optimizer (foreach, clip)", ("multi_tensor", "foreach")),
    ("reductions (norms, sums, CE)",
     ("reduce", "norm", "welford", "softmax", "nll")),
    ("copies and fills", ("copy", "memcpy", "memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def profiled(fn):
    """Run ``fn`` under torch.profiler; returns (device busy ms, device us
    by kernel class, the device kernels' events). The kernels' list is
    empty when the profiler recorded none: on the H100 a session after
    earlier ones in the same process sometimes reports no device kernel,
    so callers write such a time as not measured, never as 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3   # ms
    classes = {}
    for e in kernels:
        key = e.key.lower()
        name = next((c for c, subs in KERNEL_CLASSES
                     if any(x in key for x in subs)), "other")
        classes[name] = classes.get(name, 0.0) + e.self_device_time_total
    return busy, classes, kernels


def kernel_parts(kernels):
    """{kernel name: device ms} of profiler events."""
    name = lambda e: (re.search(r"::(\w+)[<(]", e.key) or re.search(
        r"(\w+)<", e.key) or re.search(r"(\w+)", e.key)).group(1)
    parts = {}
    for e in kernels:
        parts[name(e)] = parts.get(name(e), 0.0) + (
            e.self_device_time_total / 1e3)
    return parts


def profile_step(state, batch, sec):
    """One train step under torch.profiler: device time by kernel class,
    the top kernels, and the idle share against ``sec`` (the step's wall
    time measured without the profiler)."""
    busy, classes, kernels = profiled(lambda: train_step(state, batch))
    if not kernels:
        log("profiled step: the profiler recorded no device kernel; device "
            "busy time and idle share not measured")
        return dict(busy_ms=None, idle=None)
    log(f"profiled step: device busy {busy:.2f} ms of {sec * 1e3:.2f} ms "
        f"wall per step: idle share {1 - busy / (sec * 1e3):.4f}")
    for name, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        log(f"  {name:44s} {us / 1e3:9.3f} ms  "
            f"{100 * us / 1e3 / busy:5.1f}% of busy")
    log("  top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
            f"{e.key[:90]}")
    return dict(busy_ms=busy, idle=1 - busy / (sec * 1e3))


SPLIT_MODULES = (
    [f"vit.downsample_layers.{i}" for i in range(4)]
    + [f"vit.gscs.{i}" for i in range(4)]
    + [f"vit.stages.{i}.{j}" for i in range(4) for j in range(2)]
    + [f"vit.mlps.{i}" for i in range(4)]
    + [f"encoder{i}" for i in range(1, 6)]
    + [f"decoder{i}" for i in range(5, 0, -1)] + ["out"])


def module_split(model, image, names=SPLIT_MODULES):
    """Forward and backward ms of each named module, run alone on the
    inputs it saw (CUDA events; the UNETR blocks with their remat)."""
    mods = dict(model.named_modules())
    seen = {}
    hooks = [mods[n].register_forward_pre_hook(
        lambda m, args, n=n: seen.setdefault(
            n, tuple(t.detach() for t in args)))
        for n in names]
    with torch.no_grad():
        model(image)
    for h in hooks:
        h.remove()
    rows = []
    for n in names:
        mod, remat = mods[n], n.startswith(("encoder", "decoder"))
        times = []
        for _ in range(2):   # the first run warms up
            args = [t if t.data_ptr() == image.data_ptr()
                    else t.clone().requires_grad_() for t in seen[n]]
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            out = _call(mod, remat, *args)
            e[1].record()
            out.backward(torch.ones_like(out))
            e[2].record()
            e[2].synchronize()
            times = [e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])]
            del out, args
        rows.append((n, *times))
    model.zero_grad(set_to_none=True)
    return rows


def phase_train():
    """The train step at the recipe shape, counted and timed."""
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.standard_normal(
            (2, 4, *ROI)).astype(np.float32)).cuda(),
        "label": torch.from_numpy(rng.integers(0, 4, (2, *ROI))).cuda()}
    model = SegMamba(in_chans=4, out_chans=4, dtype=torch.bfloat16,
                     remat="convs", generator=torch.Generator().manual_seed(0),
                     device="cuda")
    state = create_train_state(model,
                               learning_rate=poly_schedule(1e-2, 1000 * 250))
    train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step = expected_counts(scan_dir=16, scan_fused=8, scan_dir_bwd=16,
                               scan_fused_bwd=8)
    losses, norms, times = [], [], []
    reset_counts()
    for i in range(5):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != per_step:
            raise AssertionError(f"step {i}: scan launches {delta}, "
                                 f"expected {per_step}")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train-step losses {losses}: not finite or "
                             "not falling")
    sec = statistics.median(times)
    log(f"train step (2x4x128^3, bf16, remat convs): {sec:.4f} s/step "
        f"(median of 5: {', '.join(f'{t:.4f}' for t in times)}); peak "
        f"device memory {peak_gib:.2f} GiB; losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}; grad norms "
        f"{', '.join(f'{v:.4f}' for v in norms)}; launches over 5 steps "
        f"{launches}")
    aug_launches = phase_train_device_aug(state, batch, per_step, sec)
    # where the step goes: kernel classes, then each module alone
    prof_stats = profile_step(state, batch, sec)
    rows = module_split(model, batch["image"])
    logits = model(batch["image"]).detach().requires_grad_()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    loss = cross_entropy_loss(logits, batch["label"])
    e[1].record()
    loss.backward()
    e[2].record()
    e[2].synchronize()
    rows.append(("loss (CE)", e[0].elapsed_time(e[1]),
                 e[1].elapsed_time(e[2])))
    train_step(state, batch)   # leaves gradients for the optimizer timing
    torch.cuda.synchronize()
    e[0].record()
    apply_gradients(state)
    e[1].record()
    e[1].synchronize()
    rows.append(("optimizer (clip + SGD)", e[0].elapsed_time(e[1]), 0.0))
    total = sum(f + b for _, f, b in rows)
    log(f"module split (each alone; sum {total:.2f} ms vs "
        f"{sec * 1e3:.2f} ms per step):")
    for n, f, b in sorted(rows, key=lambda r: -(r[1] + r[2])):
        log(f"  {n:28s} fwd {f:8.3f} ms  bwd {b:8.3f} ms  "
            f"{100 * (f + b) / total:5.1f}%")
    del model, state, batch
    torch.cuda.empty_cache()
    return dict(sec=sec, peak_gib=peak_gib, launches=launches,
                aug_launches=aug_launches, **prof_stats)


def phase_train_device_aug(state, batch, per_step, bare_sec):
    """The phase-7 step with the device chain on the same batch, each
    step's parameters drawn as the trainer draws them (``seed + 7`` with
    the CLI's seed 42, by step; the draw is timed with the step, as the
    trainer's step time has it): one warm-up, then 5 steps counted and
    timed alone, then 6 with the trainer's prefetch thread pinning and
    copying the next host batches meanwhile. What a trainer step takes
    beyond the last is its loader processes'. Returns the scan launches
    of the 5 counted steps."""
    shape = batch["image"].shape

    def step(b, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = augment_device.draw_params(
            shape, augment_device.augment_generator(42 + 7, i),
            device="cuda")
        m = train_step(state, b, augment=params)
        torch.cuda.synchronize()
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"augmented step {i}: loss {m['loss']}")
        return time.perf_counter() - t0

    step(batch, 0)                                     # warm-up
    alone = []
    reset_counts()
    for i in range(1, 6):
        before = launch_counts()
        alone.append(step(batch, i))
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != per_step:
            raise AssertionError(f"augmented step {i}: scan launches "
                                 f"{delta}, expected {per_step}")
    launches = launch_counts()
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    prefetched = [step(b, 6 + i) for i, b in enumerate(
        _prefetch(iter([host] * 6), torch.device("cuda")))]
    log(f"train step with the device chain (same batch, the trainer's "
        f"draws): alone {statistics.median(alone):.4f} s/step (median of "
        f"5: {', '.join(f'{t:.4f}' for t in alone)}; the bare step "
        f"{bare_sec:.4f}); with the prefetch thread copying host batches "
        f"{statistics.median(prefetched):.4f} s/step (median of 6: "
        f"{', '.join(f'{t:.4f}' for t in prefetched)}); launches over the "
        f"5 counted steps {launches}")
    return launches


AUG_FIRE = ("rot", "scale_fire", "noise", "blur", "blur_channel",
            "brightness", "contrast", "lowres", "lowres_channel",
            "gamma_inv", "gamma", "mirror")


def all_firing(params, shape, device):
    """``params`` with every coin set, and a noise field on ``device``."""
    for name in AUG_FIRE:
        setattr(params, name, torch.ones_like(getattr(params, name)))
    params.noise_field = torch.randn(
        shape, generator=torch.Generator(device=device).manual_seed(7),
        device=device)
    return params


def phase_device_augment(raw):
    """The on-device chain on a raw sampler batch: times (default draws,
    all coins firing), the host's draw time, and one all-firing sample on
    the card against the CPU."""
    image = torch.from_numpy(raw["data"]).cuda()
    label = torch.from_numpy(raw["seg"][:, 0].astype(np.int64)).cuda()
    shape = tuple(image.shape)

    def timed(params):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out = augment_device.device_augment(image, label, params)
        e[1].record()
        e[1].synchronize()
        if not bool(torch.isfinite(out[0]).all()) or int(out[1].min()) < 0:
            raise AssertionError("device chain: non-finite image or a "
                                 "negative label")
        return e[0].elapsed_time(e[1])

    t0 = time.perf_counter()
    draws = [augment_device.draw_params(
        shape, torch.Generator().manual_seed(s), device="cuda")
        for s in range(6)]
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) * 1e3 / len(draws)
    timed(draws[0])                                    # warm-up
    default_ms = [timed(p) for p in draws[1:]]
    fired = [" ".join(n for n in AUG_FIRE[:-1] if bool(getattr(p, n).any()))
             for p in draws[1:]]
    forced = all_firing(augment_device.draw_params(
        shape, torch.Generator().manual_seed(9), device="cuda"), shape,
        "cuda")
    timed(forced)
    all_ms = [timed(forced) for _ in range(5)]
    log(f"device augmentation (2 x 4 x {ROI[0]}^3 raw sampler batch, "
        f"CUDA events): default draws median {statistics.median(default_ms):.3f}"
        f" ms ({', '.join(f'{t:.3f}' for t in default_ms)}; fired: "
        f"{' | '.join(f or 'mirror only' for f in fired)}); every coin "
        f"firing median {statistics.median(all_ms):.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in all_ms)}); host draw of a batch's "
        f"parameters {draw_ms:.3f} ms")

    # one all-firing sample: the card against the port's CPU run
    one = forced.select([0])
    got_img, got_seg = augment_device.device_augment(image[:1], label[:1],
                                                     one)
    cpu = forced.select([0])
    cpu.noise_field = cpu.noise_field.cpu()
    t0 = time.perf_counter()
    want_img, want_seg = augment_device.device_augment(
        image[:1].cpu(), label[:1].cpu(), cpu)
    t_cpu = time.perf_counter() - t0
    scale = float(want_img.abs().max())
    err = float((got_img.cpu() - want_img).abs().max())
    ok_img = bool(torch.all((got_img.cpu() - want_img).abs()
                            <= 1e-4 * scale + 1e-4 * want_img.abs()))
    mat = (augment_device._rotation_matrix(cpu.angles)
           * cpu.scale[:, None, None])
    v = augment_device._warp_affine_shear(
        label[:1].cpu().float()[:, None], mat, 1, -1.0)[:, 0]
    amb = torch.flip((v - torch.floor(v) - 0.5).abs() < 1e-4, (1, 2, 3))
    miss = int(((got_seg.cpu() != want_seg) & ~amb).sum())
    log(f"device augmentation, one all-firing sample, card vs CPU: image "
        f"max |err| {err:.3e} at max|cpu| {scale:.3f}; labels differing "
        f"{miss} (near-half voxels not compared: {int(amb.sum())}); CPU run "
        f"{t_cpu:.2f} s")
    if not ok_img or miss:
        raise AssertionError("device augmentation: the card's sample "
                             "misses the CPU's (rtol 1e-4, atol 1e-4 x "
                             f"max; image err {err:.3e}, labels {miss})")


def phase_trainer():
    """The host augmentation chain timed in this process, the device chain
    (``phase_device_augment``), then ``segmamba_tpu_torch.train`` end to
    end on synthetic cases with the host loaders (noaug) and with the
    device chain, each resumed for one more epoch."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        paths = write_synthetic_cases(data, 6, TRAINER_CASE, seed=0)
        t_data = time.perf_counter() - t0
        sampler = PatchSampler(MedicalDataset(paths), ROI, batch_size=2,
                               rng=np.random.default_rng(0))
        chain = get_train_transforms()
        aug = []
        for seed in range(2):
            batch = sampler.generate_train_batch()
            t0 = time.perf_counter()
            chain(batch, np.random.default_rng(seed))
            aug.append(time.perf_counter() - t0)
        log(f"host augmentation (default chain, native resampler, 2 x 4 x "
            f"{ROI[0]}^3, one process): "
            f"{', '.join(f'{t:.2f}' for t in aug)} s per batch")
        phase_device_augment(sampler.generate_train_batch())
        for mode in ("noaug", "device"):
            logdir = os.path.join(tmp, f"logs_{mode}")
            common = ["--data-dir", data, "--logdir", logdir,
                      "--batch-size", "2", "--val-every", "1",
                      "--steps-per-epoch", "4", "--val-number", "2",
                      "--num-workers", "2", "--split", "0.5", "0.5", "0.0",
                      "--patch", *map(str, ROI), "--augmentation", mode]
            t0 = time.perf_counter()
            tr = train_main(common + ["--max-epochs", "1"])
            t_first = time.perf_counter() - t0
            first = tr.timer.stats()
            names = sorted(os.listdir(os.path.join(logdir, "model")))
            if ([n.rsplit("_", 1)[0] for n in names]
                    != ["best_model", "final_model"] or tr.epoch != 0
                    or tr.global_step != 4 or not np.isfinite(tr.last_loss)):
                raise AssertionError(f"trainer run ({mode}): checkpoints "
                                     f"{names}, epoch {tr.epoch}, step "
                                     f"{tr.global_step}, loss {tr.last_loss}")
            # as the JAX trainer, resume continues at the saved epoch (0)
            # and step (4): epochs 0 and 1 run, to step 12
            t0 = time.perf_counter()
            tr = train_main(common + ["--max-epochs", "2", "--resume"])
            t_resume = time.perf_counter() - t0
            if (tr.epoch != 1 or tr.global_step != 12
                    or not np.isfinite(tr.last_loss)):
                raise AssertionError(f"resumed run ({mode}): epoch "
                                     f"{tr.epoch}, step {tr.global_step}, "
                                     f"loss {tr.last_loss}")
            resumed = tr.timer.stats()
            log(f"trainer --augmentation {mode}: data {t_data:.1f} s, "
                f"epoch 0 (4 steps + validation) {t_first:.1f} s (step p50 "
                f"{first['step_time']['p50']:.4f} s, data wait max "
                f"{first['data_wait']['max']:.4f} s), resumed at epoch 0 "
                f"step 4 for epochs 0-1 {t_resume:.1f} s (step p50 "
                f"{resumed['step_time']['p50']:.4f} s, data wait max "
                f"{resumed['data_wait']['max']:.4f} s); checkpoints "
                f"{sorted(os.listdir(os.path.join(logdir, 'model')))}")
    torch.cuda.empty_cache()


def core_inputs(R, L, D, seed):
    """K6's float32 operands in the LM prefill's ranges: u unit normal,
    delta = softplus(dt + bias) with the model's dt-bias init (the wrapper
    applies softplus before the kernel), S4D-like A, and B, C column slices
    of an x_dbl with mamba-2.8b's dt_rank (160) + 2N columns."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    cpu_g = torch.Generator().manual_seed(seed)
    rn = lambda *s, sc=1.0: sc * torch.randn(*s, generator=g, device=DEVICE)
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(D, 1)
    A = (A * torch.exp(0.1 * torch.randn(D, N, generator=cpu_g))).to(DEVICE)
    bias = _dt_bias_init((D,), 0.001, 0.1, 1e-4, cpu_g).to(DEVICE)
    delta = torch.nn.functional.softplus(rn(R, L, D, sc=0.5) + bias)
    xdbl = rn(R, L, 160 + 2 * N)
    return rn(R, L, D), delta, A, xdbl[..., 160:160 + N], xdbl[..., 160 + N:]


def core_bound(direction, R, L, D):
    """Least time (ms) of one K6 call and what bounds it (``bound_of``):
    each input read once and each output written once, float32 operations
    and transcendental results. Forward: reads u, delta (R L D), B, C (R L
    N), A; writes y and the chunk states; 7 operations per (step, channel,
    state) + 1 per (step, channel). Backward: reads u, delta, dy, B, C, A,
    the states and dlast; writes du, ddelta, dA, dB, dC; 24 + 2
    operations, as ``scan_bound``. One exp per (step, channel, state)
    either way (delta is final: no softplus, no gate)."""
    seq, bc = R * L * D, R * L * N
    states = R * -(-L // scan_core.DEF_CHUNK) * N * D * 4
    if direction == "fwd":
        nbytes = 3 * seq * 4 + 2 * bc * 4 + D * N * 4 + states
        ops = seq * (7 * N + 1)
    else:
        nbytes = (5 * seq * 4 + 4 * bc * 4 + 2 * D * N * 4 + states
                  + R * N * D * 4)
        ops = seq * (24 * N + 2)
    return bound_of(nbytes, ops, seq * N)


def phase_core(results):
    """K6 forward and backward vs plain at the prefill and a ragged shape;
    fills ``results``."""
    T = scan_core.DEF_CHUNK
    rtol, atol = TOL[torch.float32]
    for shape_name, (R, L, D) in CORE_SHAPES.items():
        u, delta, A, B, C = core_inputs(R, L, D, seed=L + D + 2)
        y, st = scan_core._launch(u, delta, A, B, C, T)
        y_p, st_p = scan_core.selective_scan_core_ref(u, delta, A, B, C, T,
                                                      return_states=True)
        torch.cuda.synchronize()
        tag = f"K6 {shape_name} {(R, L, D)}"
        err = max(check_close(f"{tag} y", y, y_p, rtol, atol),
                  check_close(f"{tag} states", st, st_p, rtol, atol),
                  check_close(f"{tag} last state", scan_core._last_state(st),
                              scan_core._last_state(st_p), rtol, atol))
        ms = cuda_ms(lambda: scan_core._launch(u, delta, A, B, C, T), 10)
        plain_ms = cuda_ms(lambda: scan_core.selective_scan_core_ref(
            u, delta, A, B, C, T, return_states=True), 1, warmup=0)
        bound, bound_by = core_bound("fwd", R, L, D)
        log(f"kernel {tag} fwd: max_abs_err {err:.3e}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})")
        results.append(dict(direction="fwd", shape=shape_name,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=bound_by))
        del y, y_p, st_p

        # backward through the public wrapper and its autograd Function
        g = torch.Generator(device=DEVICE).manual_seed(L)
        dy = torch.randn(R, L, D, generator=g, device=DEVICE)
        dlast = torch.randn(R, D, N, generator=g, device=DEVICE)
        leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
        before = scan_core.BWD_LAUNCHES
        out, last = scan_core.selective_scan_kernel(*leaves,
                                                    return_last_state=True)
        if out.grad_fn is None or last.grad_fn is None:
            raise AssertionError(f"{tag}: CUDA forward with requires_grad "
                                 "inputs has no grad_fn")
        torch.autograd.backward((out, last), (dy, dlast))
        if scan_core.BWD_LAUNCHES != before + 1:
            raise AssertionError(f"{tag}: backward kernel launches "
                                 f"{scan_core.BWD_LAUNCHES - before}")
        got = [t.grad for t in leaves]
        del out, last, leaves
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want = scan_core.selective_scan_core_bwd_ref(u, delta, A, B, C, dy,
                                                     dlast, T)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        err = 0.0
        for name, gk, w in zip(CORE_GRADS, got, want):
            a = atol * max(1.0, float(w.abs().max())) \
                if name in ("dA", "dB", "dC") else atol
            err = max(err, check_close(f"{tag} {name}", gk, w, rtol, a))
        del got, want
        ms = cuda_ms(lambda: scan_core._launch_bwd(u, delta, A, B, C, dy,
                                                   dlast, st, T), 10)
        plain_ms = cuda_ms(lambda: scan_core.selective_scan_core_bwd_ref(
            u, delta, A, B, C, dy, dlast, T), 1, warmup=0)
        bound, bound_by = core_bound("bwd", R, L, D)
        log(f"kernel {tag} bwd: max_abs_err {err:.3e}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (peak {peak / 2 ** 30:.2f} GiB), "
            f"bound {bound:.4f} ms ({bound_by})")
        row = dict(direction="bwd", shape=shape_name, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by)
        del u, delta, A, B, C, st, dy, dlast
        torch.cuda.empty_cache()
        if shape_name == "prefill":
            parts = breakdown_in_child("bwd_core", f"{tag} bwd")
            row["device_ms"] = None if parts is None else sum(parts.values())
        results.append(row)


def core_bwd_call(R, L, D):
    """K6's backward kernel alone at (R, L, D) on phase 9's operands: one
    forward launch for the chunk exit states, then a closure that launches
    it (not counted)."""
    T = scan_core.DEF_CHUNK
    u, delta, A, B, C = core_inputs(R, L, D, seed=L + D + 2)
    _, st = scan_core._launch(u, delta, A, B, C, T)
    g = torch.Generator(device=DEVICE).manual_seed(L)
    dy = torch.randn(R, L, D, generator=g, device=DEVICE)
    dlast = torch.randn(R, D, N, generator=g, device=DEVICE)
    return lambda: scan_core._launch_bwd(u, delta, A, B, C, dy, dlast, st, T)


def build_lm(dtype, **overrides):
    """The mamba-2.8b-wide LM with random weights from seed 0, drawn on the
    card."""
    return MambaLMHeadModel(
        **{**LM_CONFIG, **overrides}, dtype=dtype,
        generator=torch.Generator(device=DEVICE).manual_seed(0),
        device=DEVICE).eval()


def set_scan_impl(model, impl):
    for blk in model.backbone.layers:
        blk.mixer.scan_impl = impl


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def phase_lm():
    """The Mamba LM serving path at mamba-2.8b width; returns its stats."""
    n_layer = LM_CONFIG["n_layer"]
    t0 = time.perf_counter()
    model = build_lm(torch.float32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"LM: {n_params / 1e9:.3f} B parameters (vocab {model.vocab_size}),"
        f" built on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    batch, L = LM_CHECK
    ids = torch.from_numpy(rng.integers(0, LM_CONFIG["vocab_size"],
                                        (batch, L))).to(DEVICE)

    # a. float32 prefill, kernel vs plain scans
    with torch.inference_mode():
        reset_counts()
        h, caches = model.backbone.prefill(ids)
        torch.cuda.synchronize()
        prefill_counts = launch_counts()
        if prefill_counts != expected_counts(scan_core=n_layer):
            raise AssertionError(f"prefill launches {prefill_counts}, "
                                 f"expected scan_core {n_layer} only")
        logits = model._logits(h[:, -1])
        set_scan_impl(model, "chunked")
        h_p, caches_p = model.backbone.prefill(ids)
        set_scan_impl(model, "auto")
        logits_p = model._logits(h_p[:, -1])
        torch.cuda.synchronize()
        if launch_counts() != prefill_counts:
            raise AssertionError("a kernel launched in the plain prefill")
        err = rel_l2(logits, logits_p)
        if not err <= 1e-3 or not torch.isfinite(logits).all():
            raise AssertionError(f"f32 prefill logits: relative L2 {err}")
        worst = 0.0
        for i, (c, cp) in enumerate(zip(caches, caches_p)):
            scale = float(cp["ssm"].abs().max())
            e = check_close(f"layer {i} ssm cache", c["ssm"], cp["ssm"],
                            2e-3, 2e-3 * scale)
            worst = max(worst, e / scale)
        log(f"f32 prefill {LM_CHECK}: logits relative L2 {err:.3e} (kernel "
            f"vs plain scans); worst SSM cache max-abs-err / max {worst:.3e};"
            f" launches {prefill_counts}")
        del h_p, caches_p, logits_p, caches

        # b. float32 full forward through K2
        reset_counts()
        full = model(ids)
        torch.cuda.synchronize()
        fwd_counts = launch_counts()
        if fwd_counts != expected_counts(scan_fused=n_layer):
            raise AssertionError(f"full forward launches {fwd_counts}")
        err_fwd = rel_l2(full[:, -1], logits)
        if not err_fwd <= 1e-3:
            raise AssertionError(f"full forward vs prefill logits: relative "
                                 f"L2 {err_fwd}")
        log(f"f32 full forward: logits {tuple(full.shape)}, last position "
            f"vs prefill relative L2 {err_fwd:.3e}; launches {fwd_counts}")
        del full, h

        # a'/b'. the same prefill and full forward through K7 (mxu)
        set_scan_impl(model, "mxu")
        reset_counts()
        h_m, _ = model.backbone.prefill(ids)
        torch.cuda.synchronize()
        mxu_prefill_counts = launch_counts()
        if mxu_prefill_counts != expected_counts(scan_mxu=n_layer):
            raise AssertionError(f"mxu prefill launches {mxu_prefill_counts}"
                                 f", expected scan_mxu {n_layer} only")
        logits_m = model._logits(h_m[:, -1])
        err_m = rel_l2(logits_m, logits)
        if not err_m <= 1e-3 or not torch.isfinite(logits_m).all():
            raise AssertionError(f"mxu f32 prefill logits vs K6's: relative "
                                 f"L2 {err_m}")
        reset_counts()
        full_m = model(ids)
        torch.cuda.synchronize()
        mxu_fwd_counts = launch_counts()
        if mxu_fwd_counts != expected_counts(scan_mxu=n_layer):
            raise AssertionError(f"mxu full forward launches "
                                 f"{mxu_fwd_counts}")
        err_fm = rel_l2(full_m[:, -1], logits)
        if not err_fm <= 1e-3:
            raise AssertionError(f"mxu full forward vs K6 prefill logits: "
                                 f"relative L2 {err_fm}")
        with scan_mxu.tally() as tl32:
            model.backbone.prefill(ids)
        set_scan_impl(model, "auto")
        log(f"f32 mxu prefill {LM_CHECK}: logits vs K6's relative L2 "
            f"{err_m:.3e}, launches {mxu_prefill_counts}; mxu full forward "
            f"vs K6 prefill relative L2 {err_fm:.3e}, launches "
            f"{mxu_fwd_counts}; ratio-form share of the prefill "
            f"{tl32.share():.4f} ({tl32.ratio} of {tl32.ratio + tl32.step} "
            "units)")
        del h_m, logits_m, full_m, logits

    # c. a gradient through the prefill: K6 backward in every layer
    model.requires_grad_(False)
    model.backbone.embedding.weight.requires_grad_(True)
    reset_counts()
    h, caches = model.backbone.prefill(ids[:1])
    loss = model._logits(h[:, -1]).logsumexp(-1).mean() + sum(
        c["ssm"].square().mean() for c in caches)
    loss.backward()
    torch.cuda.synchronize()
    grad_counts = launch_counts()
    if grad_counts != expected_counts(scan_core=n_layer,
                                      scan_core_bwd=n_layer):
        raise AssertionError(f"prefill gradient launches {grad_counts}")
    grad = model.backbone.embedding.weight.grad
    if not torch.isfinite(grad).all() or not grad.abs().max() > 0:
        raise AssertionError("prefill gradient: not finite or all zero")
    log(f"prefill gradient (1 x {L}): loss {float(loss.detach()):.5f}, "
        f"max |d embedding| {float(grad.abs().max()):.4e}; launches "
        f"{grad_counts}")
    grad_k6 = grad.clone()
    del h, caches, loss, grad
    model.backbone.embedding.weight.grad = None
    set_scan_impl(model, "mxu")
    reset_counts()
    h, caches = model.backbone.prefill(ids[:1])
    loss = model._logits(h[:, -1]).logsumexp(-1).mean() + sum(
        c["ssm"].square().mean() for c in caches)
    loss.backward()
    torch.cuda.synchronize()
    set_scan_impl(model, "auto")
    mxu_grad_counts = launch_counts()
    if mxu_grad_counts != expected_counts(scan_mxu=n_layer,
                                          scan_mxu_bwd=n_layer):
        raise AssertionError(f"mxu prefill gradient launches "
                             f"{mxu_grad_counts}")
    grad = model.backbone.embedding.weight.grad
    err_g = rel_l2(grad, grad_k6)
    if not torch.isfinite(grad).all() or not err_g <= 1e-3:
        raise AssertionError(f"mxu prefill gradient: vs K6's relative L2 "
                             f"{err_g}, or not finite")
    log(f"mxu prefill gradient (1 x {L}): d embedding vs K6's relative L2 "
        f"{err_g:.3e}; launches {mxu_grad_counts}")
    del model, h, caches, loss, grad, grad_k6
    gc.collect()
    torch.cuda.empty_cache()

    # d. bfloat16 serving
    model = build_lm(torch.bfloat16)
    batch, L, new = LM_SERVE
    ids = torch.from_numpy(rng.integers(0, LM_CONFIG["vocab_size"],
                                        (batch, L))).to(DEVICE)
    with torch.inference_mode():
        h, caches = model.backbone.prefill(ids)
        logits = model._logits(h[:, -1])
        h1, _ = model.backbone.step(logits.argmax(-1), caches)
        if not (torch.isfinite(logits).all()
                and torch.isfinite(model._logits(h1)).all()):
            raise AssertionError("bf16 prefill or step logits not finite")
        del h, caches, logits, h1
    model.generate(ids, 2)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_s, total_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        model.generate(ids, 1)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        reset_counts()
        t0 = time.perf_counter()
        out = model.generate(ids, new)
        torch.cuda.synchronize()
        total_s.append(time.perf_counter() - t0)
        gen_counts = launch_counts()
        if gen_counts != expected_counts(scan_core=n_layer):
            raise AssertionError(f"generate launches {gen_counts}: "
                                 f"expected {n_layer} K6, none decoding")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    toks = out[:, L:]
    if (out.shape != (batch, L + new) or not torch.equal(out[:, :L], ids)
            or int(toks.min()) < 0 or int(toks.max()) >= model.vocab_size):
        raise AssertionError(f"generate: shape {tuple(out.shape)} or tokens "
                             "out of range")
    set_scan_impl(model, "mxu")
    model.generate(ids, 1)                       # warm-up
    mxu_prefill_s = []
    for _ in range(3):
        reset_counts()
        t0 = time.perf_counter()
        model.generate(ids, 1)
        torch.cuda.synchronize()
        mxu_prefill_s.append(time.perf_counter() - t0)
        mxu_gen_counts = launch_counts()
        if mxu_gen_counts != expected_counts(scan_mxu=n_layer):
            raise AssertionError(f"mxu generate launches {mxu_gen_counts}")
    with scan_mxu.tally() as tl16:
        model.generate(ids, 1)
    set_scan_impl(model, "auto")
    prefill_ms = statistics.median(prefill_s) * 1e3
    mxu_prefill_ms = statistics.median(mxu_prefill_s) * 1e3
    log(f"bf16 generate prefill ({batch} x {L}) through K7 "
        f"(scan_impl='mxu'): {mxu_prefill_ms:.2f} ms (medians of 3: "
        f"{', '.join(f'{t * 1e3:.2f}' for t in mxu_prefill_s)}) beside K6's "
        f"{prefill_ms:.2f} ms; ratio-form share {tl16.share():.4f}; launches "
        f"{mxu_gen_counts}")
    total_ms = statistics.median(total_s) * 1e3
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    log(f"bf16 generate ({batch} x {L} prompt, {new} greedy tokens): "
        f"prefill {prefill_ms:.2f} ms, total {total_ms:.2f} ms (medians of "
        f"3: {', '.join(f'{t * 1e3:.2f}' for t in total_s)}), decode "
        f"{decode_ms:.3f} ms/token, {batch * new / (total_ms / 1e3):.2f} new "
        f"tokens/s; peak device memory {peak_gib:.2f} GiB; launches per "
        f"generate {gen_counts}")
    decode_stats = profile_decode(model, ids)
    del model, out
    gc.collect()
    torch.cuda.empty_cache()

    # e. from_pretrained on a tiny snapshot
    with tempfile.TemporaryDirectory() as tmp:
        src = MambaLMHeadModel(50, 64, 2, rms_norm=True,
                               pad_vocab_size_multiple=8,
                               generator=torch.Generator().manual_seed(1))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(dict(d_model=64, n_layer=2, vocab_size=50,
                           pad_vocab_size_multiple=8), f)
        sd = dict(src.state_dict(), **{
            "lm_head.weight": src.backbone.embedding.weight.detach()})
        torch.save(sd, os.path.join(tmp, "pytorch_model.bin"))
        loaded = from_pretrained(tmp, device=DEVICE)
        src = src.to(DEVICE).eval()
        small = torch.from_numpy(rng.integers(0, 50, (2, 40))).to(DEVICE)
        with torch.inference_mode():
            if not torch.equal(loaded(small), src(small)):
                raise AssertionError("from_pretrained: logits differ")
    log("from_pretrained: tiny snapshot (vocab 50 -> 56, tied lm_head) "
        "loaded strictly, same logits")
    return dict(prefill_counts=prefill_counts, grad_counts=grad_counts,
                gen_counts=gen_counts, prefill_ms=prefill_ms,
                decode_ms=decode_ms, peak_gib=peak_gib,
                mxu_prefill_counts=mxu_prefill_counts,
                mxu_fwd_counts=mxu_fwd_counts,
                mxu_grad_counts=mxu_grad_counts,
                mxu_gen_counts=mxu_gen_counts, mxu_prefill_ms=mxu_prefill_ms,
                mxu_share_f32=tl32.share(), mxu_share_bf16=tl16.share(),
                **decode_stats)


def profile_decode(model, ids, steps=8):
    """Where a decode token's time goes: ``steps`` greedy steps after a
    prefill, wall time per token (host clock, unprofiled), then the same
    steps under torch.profiler: device busy time per token, the idle share,
    kernel launches per token and device time by kernel class."""
    with torch.inference_mode():
        h, caches = model.backbone.prefill(ids)
        tok = model._logits(h[:, -1]).argmax(-1)

        def run():
            nonlocal tok, caches
            for _ in range(steps):
                h, caches = model.backbone.step(tok, caches)
                tok = model._logits(h).argmax(-1)

        run()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        busy, classes, kernels = profiled(run)
    if not kernels:
        log(f"decode profile ({steps} steps): {wall:.3f} ms/token wall; the "
            "profiler recorded no device kernel, so device busy time, idle "
            "share and launches per token are not measured")
        return dict(decode_wall_ms=wall, decode_busy_ms=None,
                    decode_launches=None)
    busy /= steps
    launches = sum(e.count for e in kernels) / steps
    log(f"decode profile ({steps} steps): {wall:.3f} ms/token wall, device "
        f"busy {busy:.3f} ms/token, idle share {1 - busy / wall:.4f}, "
        f"{launches:.0f} kernel launches per token")
    for name, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        log(f"  {name:44s} {us / 1e3 / steps:9.3f} ms/token  "
            f"{100 * us / 1e3 / steps / busy:5.1f}% of busy")
    log("  top kernels (per token):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms "
            f"x{e.count / steps:<5.0f} {e.key[:90]}")
    return dict(decode_wall_ms=wall, decode_busy_ms=busy,
                decode_launches=launches)


def proj_bound(direction, flags, R, L, E, rank, dtype):
    """Least time (ms) of one K8 call and what bounds it, as
    ``scan_bound``: bytes of xc (and z, acc) read once and of the output
    written once (backward: dout and the states read, dxc, dz, dacc and the
    weight gradients written), against its operations at the peak rate of
    their type (``bound_of``). The scan's are float32: per (step,
    channel, state) 7 forward / 24 backward, plus 14 per (step, channel),
    and the delta product 2 R E per step and row (three times backward:
    recomputed, and its two adjoints); its transcendental results as
    ``scan_bound``'s (softplus always, the gate with z). The x_proj
    product, 2 E (R + 2N) per step and row (three times backward
    likewise), is bf16 x bf16 -> f32 when the I/O is bf16, which the
    tensor cores run at BF16_TC_FLOP_PER_S, else float32."""
    es = 2 if dtype == torch.bfloat16 else 4
    seq = R * L * E
    z, acc = flags["z"], flags["acc"]
    ncol = rank + 2 * N
    params = (E * ncol + rank * E + E * N + 2 * E) * 4
    times = 1 if direction == "fwd" else 3
    xproj_ops = times * R * L * 2 * E * ncol
    f32_ops = times * R * L * 2 * rank * E
    if direction == "fwd":
        nbytes = (2 + z + acc) * seq * es + params
        f32_ops += seq * (7 * N + 14)
    else:
        states = R * -(-L // scan_proj.DEF_CHUNK) * N * E * 4
        n_seq = (2 + z + (z and acc)) + (1 + z + (z and acc))
        nbytes = n_seq * seq * es + states + 2 * params
        f32_ops += seq * (24 * N + 14)
    if dtype == torch.bfloat16:
        return bound_of(nbytes, f32_ops, seq * (N + 1 + z), xproj_ops)
    return bound_of(nbytes, f32_ops + xproj_ops, seq * (N + 1 + z))


def proj_inputs(R, L, E, rank, dtype, seed):
    """K8's operands in the model's ranges: unit-normal xc, z, acc, x_proj
    N(0, 0.1^2), dt_proj N(0, 0.3^2), the model's dt-bias init, S4D-like
    A, unit-normal D."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cpu_g = torch.Generator().manual_seed(seed)
    rn = lambda *s, sc=1.0: sc * torch.randn(*s, generator=g, device="cuda")
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(E, 1)
    A = (A * torch.exp(0.1 * torch.randn(E, N, generator=cpu_g))).cuda()
    bias = _dt_bias_init((E,), 0.001, 0.1, 1e-4, cpu_g).cuda()
    return dict(xc=rn(R, L, E).to(dtype), z=rn(R, L, E).to(dtype),
                acc=rn(R, L, E).to(dtype),
                x_proj=rn(E, rank + 2 * N, sc=0.1).to(dtype),
                dt_proj=rn(rank, E, sc=0.3), dt_bias=bias, A=A, D=rn(E))


PROJ_ARGS = ("xc", "x_proj", "dt_proj", "dt_bias", "A", "D")
PROJ_GRADS = ("dxc", "dx_proj", "ddt_proj", "ddt_bias", "dA", "dD", "dz",
              "dacc")


SLICE_SHAPES = {"stage0": (262144, 96, 64), "stage3": (512, 768, 8)}


def phase_slice_kernel(results, bytes_per_elem):
    """K5 forward and backward vs plain at the shapes of the first and the
    last stage (L, E, S = 262144, 96, 64: one channel block; 512, 768, 8:
    several), each at R = 1 and the train step's 2; fills ``results``.
    Beside the forward kernel, the interleave-copy form it replaces: K2 on
    interleaved copies of u, dt, z, B, C and the de-interleave of its
    output."""
    for (stage, (L, E, S)), R, dtype in itertools.product(
            SLICE_SHAPES.items(), (1, 2), (torch.float32, torch.bfloat16)):
        a = scan_inputs(R, L, E, dtype, seed=L + E + 3 + R)
        rtol, atol = TOL[dtype]
        args = (a["u"], a["dt"], a["z"], a["A"], a["B"], a["C"], a["D"],
                a["bias"])
        kern = lambda s=False: scan_dir.mamba_scan_fused_slice(
            *args, nslices=S, return_states=s)
        plain = lambda s=False: scan_dir.mamba_scan_fused_slice_ref(
            *args, nslices=S, return_states=s)
        il = lambda t: scan_dir._interleave(t, S)

        def copy_form():
            u, dt, z, A, B, C, D, bias = args
            return scan_dir._deinterleave(scan_fused.mamba_scan_fused(
                il(u), il(dt), il(z), A, il(B), il(C), D, bias), S)

        out_k, st_k = kern(True)
        out_p, st_p = plain(True)
        torch.cuda.synchronize()
        tag = f"K5 fwd {stage} R={R} {str(dtype)[6:]}"
        err = check_close(f"{tag} out", out_k, out_p, rtol, atol)
        err_st = check_close(f"{tag} states", st_k, st_p,
                             *TOL[torch.float32])
        err_copy = check_close(f"{tag} vs interleave copy", copy_form(),
                               out_p, rtol, atol)
        del out_k, st_k, out_p, st_p
        ms = cuda_ms(kern, 5)
        copy_ms = cuda_ms(copy_form, 5)
        plain_ms = cuda_ms(plain, 1, warmup=0)
        bound, bound_by = scan_bound("fwd", "fused_gate", R, L, E, dtype)
        log(f"kernel {tag}: max_abs_err {err:.3e} (states {err_st:.3e}, "
            f"interleave-copy form {err_copy:.3e}), kernel {ms:.4f} ms, "
            f"interleave copies + K2 {copy_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})")
        results.append(dict(direction="fwd", stage=stage, R=R,
                            dtype=str(dtype)[6:],
                            max_abs_err=max(err, err_st), ms=ms,
                            copy_ms=copy_ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=bound_by))
        # backward, the plain backward over channel slices as in
        # phase 5
        g = torch.Generator(device="cuda").manual_seed(L + R)
        dout = torch.randn(R, L, E, generator=g, device="cuda").to(dtype)
        leaves = [t.detach().requires_grad_() for t in args]
        before = scan_dir.SLICE_BWD_LAUNCHES
        out = scan_dir.mamba_scan_fused_slice(*leaves, nslices=S)
        if out.grad_fn is None:
            raise AssertionError(f"{tag}: no grad_fn")
        out.backward(dout)
        if scan_dir.SLICE_BWD_LAUNCHES != before + 1:
            raise AssertionError(f"{tag}: backward launches "
                                 f"{scan_dir.SLICE_BWD_LAUNCHES - before}")
        lu, ldt, lz, lA, lB, lC, lD, lb = leaves
        got = (lu.grad, ldt.grad, lz.grad, None, lA.grad, lB.grad,
               lC.grad, lD.grad, lb.grad)
        del out, leaves
        torch.cuda.empty_cache()
        budget = PLAIN_BWD_SHARE * torch.cuda.mem_get_info()[0]
        width = math.ceil(E / math.ceil(
            bytes_per_elem * R * L * E * N / budget))
        seq = dict(u=a["u"], dt=a["dt"], z=a["z"], acc=None, B=a["B"],
                   C=a["C"])
        params = (a["A"], a["D"], a["bias"])

        def plain_bwd():
            return plain_bwd_sliced(seq, params, dout, gate=True,
                                    reverse=False, width=width,
                                    nslices=S)

        want = plain_bwd()
        tag = f"K5 bwd {stage} R={R} {str(dtype)[6:]}"
        err = grad_check(tag, got, want, dtype)
        del got, want
        kern = slice_bwd_call(R, (L, E, S), dtype, a, dout)
        ms = cuda_ms(kern, 5)
        plain_ms = cuda_ms(plain_bwd, 1, warmup=0)
        bound, bound_by = scan_bound("bwd", "fused_gate", R, L, E, dtype)
        log(f"kernel {tag}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (channel slices of {width}), "
            f"bound {bound:.4f} ms ({bound_by})")
        row = dict(direction="bwd", stage=stage, R=R, dtype=str(dtype)[6:],
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by)
        del a, dout, kern
        torch.cuda.empty_cache()
        if stage == "stage0" and R == 2 and dtype == torch.bfloat16:
            parts = breakdown_in_child("bwd_slice", tag)
            row["device_ms"] = None if parts is None else sum(parts.values())
        results.append(row)


def slice_bwd_call(R, shape, dtype, a=None, dout=None):
    """K5's backward kernel alone at (R, L, E, S) (phase 11's operands
    unless given): one forward launch for the chunk exit states, then a
    closure that launches it (not counted)."""
    L, E, S = shape
    if a is None:
        a = scan_inputs(R, L, E, dtype, seed=L + E + 3 + R)
        g = torch.Generator(device="cuda").manual_seed(L + R)
        dout = torch.randn(R, L, E, generator=g, device="cuda").to(dtype)
    args = (a["u"], a["dt"], a["z"], None, a["A"], a["B"], a["C"], a["D"],
            a["bias"])
    kw = dict(reverse=False, gate=True, chunk_size=scan_dir.DEF_CHUNK,
              nslices=S)
    _, states = scan_dir._launch(*args, return_states=True, **kw)
    return lambda: scan_dir._launch_bwd(*args, dout, states, **kw)


def proj_plain_bwd(a, flags, dout):
    kw = dict(z=a["z"] if flags["z"] else None,
              acc=a["acc"] if flags["acc"] else None,
              reverse=flags["reverse"])
    return scan_proj.mamba_scan_proj_bwd_ref(*(a[k] for k in PROJ_ARGS),
                                             dout, **kw)


def proj_call(direction, R, dtype=torch.bfloat16, flags=None):
    """One K8 kernel call at stage 0 (phase 11's operands, forward + acc +
    gate unless ``flags``) as a closure: the forward launch, or the
    backward launch from a forward's chunk states (not counted)."""
    L, E, _, rank = STAGE0
    flags = flags or PROJ_CHAIN["forward_acc_gate"]
    a = proj_inputs(R, L, E, rank, dtype, seed=L + 6 + R)
    args = [a[k] for k in PROJ_ARGS] + [a["z"] if flags["z"] else None,
                                        a["acc"] if flags["acc"] else None]
    kw = dict(reverse=flags["reverse"], chunk_size=scan_proj.DEF_CHUNK)
    if direction == "fwd":
        return lambda: scan_proj._launch(*args, return_states=False, **kw)
    g = torch.Generator(device="cuda").manual_seed(L + 9)
    dout = torch.randn(R, L, E, generator=g, device="cuda").to(dtype)
    _, states = scan_proj._launch(*args, return_states=True, **kw)
    return lambda: scan_proj._launch_bwd(*args, dout, states, **kw)


def phase_proj_kernel(results):
    """K8 forward (R = 2, and R = 1 in the last flag set) and backward
    (R = 1) vs plain at stage 0, in the three flag sets of the "proj"
    chain; fills ``results``. The plain backward cannot be split by channel
    (the projections mix them): its peak per (row, step, channel, state) is
    measured at L = 16384 first, and the full length must fit in
    PROJ_PLAIN_SHARE of free memory. The bf16 forward + acc + gate
    backward is also timed at R = 2, and K8's bf16 calls split by kernel
    name (``--breakdown proj_fwd`` / ``proj_bwd``)."""
    L, E, _, rank = STAGE0
    for dtype, R in ((torch.float32, 2), (torch.bfloat16, 2),
                     (torch.float32, 1), (torch.bfloat16, 1)):
        a = proj_inputs(R, L, E, rank, dtype, seed=L + 7)
        rtol, atol = TOL[dtype]
        chain = PROJ_CHAIN if R == 2 else ("forward_acc_gate",)
        for fname in chain:
            flags = PROJ_CHAIN[fname]
            kw = dict(z=a["z"] if flags["z"] else None,
                      acc=a["acc"] if flags["acc"] else None,
                      reverse=flags["reverse"])
            args = [a[k] for k in PROJ_ARGS]
            kern = lambda s=False: scan_proj.mamba_scan_proj(
                *args, return_states=s, **kw)
            plain = lambda s=False: scan_proj.mamba_scan_proj_ref(
                *args, return_states=s, **kw)
            out_k, st_k = kern(True)
            out_p, st_p = plain(True)
            torch.cuda.synchronize()
            tag = f"K8 fwd {fname} R={R} {str(dtype)[6:]}"
            err = check_close(f"{tag} out", out_k, out_p, rtol, atol)
            err_st = check_close(f"{tag} states", st_k, st_p,
                                 *TOL[torch.float32])
            del out_k, st_k, out_p, st_p
            ms = cuda_ms(kern, 5)
            plain_ms = cuda_ms(plain, 1, warmup=0)
            bound, bound_by = proj_bound("fwd", flags, R, L, E, rank, dtype)
            log(f"kernel {tag}: max_abs_err {err:.3e} (states {err_st:.3e}),"
                f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound:.4f} ms ({bound_by})")
            results.append(dict(direction="fwd", variant=fname, R=R,
                                dtype=str(dtype)[6:],
                                max_abs_err=max(err, err_st), ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by))
        del a
        torch.cuda.empty_cache()

    # the plain backward's peak at a short length, then the full length
    short = 16384
    a = proj_inputs(1, short, E, rank, torch.float32, seed=5)
    dout = torch.randn(1, short, E, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    proj_plain_bwd(a, PROJ_CHAIN["forward_acc_gate"], dout)
    torch.cuda.synchronize()
    per_elem = (torch.cuda.max_memory_allocated() - base) / (short * E * N)
    del a, dout
    torch.cuda.empty_cache()
    need = per_elem * L * E * N
    free = torch.cuda.mem_get_info()[0]
    log(f"K8 plain backward: {per_elem:.1f} bytes of peak per (row, step, "
        f"channel, state) at L = {short}; {need / 2 ** 30:.1f} GiB predicted "
        f"at R = 1, L = {L}, {free / 2 ** 30:.1f} GiB free")
    if need > PROJ_PLAIN_SHARE * free:
        raise AssertionError("K8 plain backward at the full length does not "
                             "fit the card")
    for dtype in (torch.float32, torch.bfloat16):
        a = proj_inputs(1, L, E, rank, dtype, seed=L + 8)
        g = torch.Generator(device="cuda").manual_seed(L + 9)
        dout = torch.randn(1, L, E, generator=g, device="cuda").to(dtype)
        for fname, flags in PROJ_CHAIN.items():
            names = list(PROJ_ARGS) + [k for k in ("z", "acc") if flags[k]]
            leaves = {k: a[k].detach().requires_grad_() for k in names}
            before = scan_proj.BWD_LAUNCHES
            out = scan_proj.mamba_scan_proj(
                *(leaves[k] for k in PROJ_ARGS), z=leaves.get("z"),
                acc=leaves.get("acc"), reverse=flags["reverse"])
            if out.grad_fn is None:
                raise AssertionError(f"K8 {fname}: no grad_fn")
            out.backward(dout)
            if scan_proj.BWD_LAUNCHES != before + 1:
                raise AssertionError(f"K8 {fname}: backward launches "
                                     f"{scan_proj.BWD_LAUNCHES - before}")
            got = [leaves[k].grad if k in leaves else None
                   for k in list(PROJ_ARGS) + ["z", "acc"]]
            del out, leaves
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            want = proj_plain_bwd(a, flags, dout)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            tag = f"K8 bwd {fname} R=1 {str(dtype)[6:]}"
            rtol, atol = TOL[dtype]
            err, rel = 0.0, []
            for name, gk, w in zip(PROJ_GRADS, got, want):
                if w is None:
                    continue
                scale = max(1.0, float(w.abs().max()))
                big = name in ("dxc", "dz", "dacc")
                e = check_close(f"{tag} {name}", gk, w, rtol,
                                atol if big else atol * scale)
                err = max(err, e)
                rel.append(f"{name} {e / scale:.1e}")
            del got, want
            torch.cuda.empty_cache()
            kw = dict(z=a["z"] if flags["z"] else None,
                      acc=a["acc"] if flags["acc"] else None)
            _, states = scan_proj._launch(
                *(a[k] for k in PROJ_ARGS), kw["z"], kw["acc"],
                reverse=flags["reverse"], chunk_size=scan_proj.DEF_CHUNK,
                return_states=True)
            ms = cuda_ms(lambda: scan_proj._launch_bwd(
                *(a[k] for k in PROJ_ARGS), kw["z"], kw["acc"], dout, states,
                reverse=flags["reverse"], chunk_size=scan_proj.DEF_CHUNK), 5)
            plain_ms = cuda_ms(lambda: proj_plain_bwd(a, flags, dout), 1,
                               warmup=0)
            bound, bound_by = proj_bound("bwd", flags, 1, L, E, rank, dtype)
            log(f"kernel {tag}: max_abs_err {err:.3e} (per gradient, over "
                f"max(1, max|plain|): {', '.join(rel)}), kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms (peak {peak / 2 ** 30:.2f} GiB), "
                f"bound {bound:.4f} ms ({bound_by})")
            results.append(dict(direction="bwd", variant=fname, R=1,
                                dtype=str(dtype)[6:], max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by))
            del states
            torch.cuda.empty_cache()
        del a, dout
        torch.cuda.empty_cache()
    # the train step's rows: the bf16 forward + acc + gate backward at R = 2
    flags = PROJ_CHAIN["forward_acc_gate"]
    ms = cuda_ms(proj_call("bwd", 2), 5)
    bound, bound_by = proj_bound("bwd", flags, 2, L, E, rank, torch.bfloat16)
    log(f"kernel K8 bwd forward_acc_gate R=2 bfloat16: kernel {ms:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by})")
    results.append(dict(direction="bwd", variant="forward_acc_gate", R=2,
                        dtype="bfloat16", ms=ms, bound_ms=bound,
                        bound_by=bound_by))
    torch.cuda.empty_cache()
    sides = (("fwd", 2), ("bwd", 1))
    for (direction, R), parts in zip(sides, breakdowns_in_children([
            (f"proj_{d}", f"K8 {d} stage0 R={r} bfloat16")
            for d, r in sides])):
        row = next(r for r in results if r["direction"] == direction
                   and r["R"] == R and r["dtype"] == "bfloat16"
                   and r["variant"] == "forward_acc_gate")
        row["device_ms"] = None if parts is None else sum(parts.values())
        row["device_parts"] = parts


def build_composition(comp, dtype, remat=False):
    """The full-width SegMamba built through ``Config.build_model`` with
    seed-0 weights (the same for every composition): "dir2", "dir", "proj",
    or "dir_slice" (``scan_impl="dir"`` with ``slice_kernel=True`` set on
    every MambaV3)."""
    impl = "dir" if comp == "dir_slice" else comp
    cfg = Config(model=ModelConfig(scan_impl=impl, remat=remat,
                                   dtype=str(dtype)[6:]))
    model = cfg.build_model(device="cuda",
                            generator=torch.Generator().manual_seed(0))
    if comp == "dir_slice":
        for m in model.modules():
            if isinstance(m, MambaV3):
                m.slice_kernel = True
    return model


def composition_counts(comp, per, model):
    """Scan launches of one pass through the 8 Mamba layers (2 at stage 0,
    d_inner 96), times ``per``. "mxu" derives its count from the model: one
    K7 per direction of every MambaV3 (3 with the slice direction)."""
    if comp == "mxu":
        dirs = sum(3 if m.bimamba_type == "v3" else 2
                   for m in model.modules() if isinstance(m, MambaV3))
        return {"scan_mxu": dirs * per}
    fwd = {"dir2": dict(scan_dir=16, scan_fused=8),
           "dir": dict(scan_dir=16, scan_fused=8),
           "dir_slice": dict(scan_dir=16, scan_dir_slice=8),
           "proj": dict(scan_proj=6, scan_dir=12, scan_fused=6)}[comp]
    return {k: v * per for k, v in fwd.items()}


def phase_compositions():
    """Full-width forwards and the bench case under each composition:
    float32 window logits vs dir2's (kernel paths, same weights), bfloat16
    window logits vs dir2's (relative L2), exact launch counts, ms per
    window and s/case, each in turn in this call."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, *ROI)).astype(np.float32)).cuda()
    case = np.moveaxis(rng.standard_normal((1, *CASE_SHAPE, 4)), -1, 1)
    case = torch.from_numpy(case.astype(np.float32)).cuda()
    stats, ref = {}, {}
    for comp in COMPOSITIONS:
        model = build_composition(comp, torch.float32).eval()
        with torch.inference_mode():
            y32 = model(x)
        del model
        model = build_composition(comp, torch.bfloat16).eval()
        with torch.inference_mode():
            reset_counts()
            y16 = model(x)
            torch.cuda.synchronize()
            counts = launch_counts()
            if counts != expected_counts(**composition_counts(comp, 1,
                                                              model)):
                raise AssertionError(f"{comp}: window launches {counts}")
            if not (torch.isfinite(y32).all() and torch.isfinite(y16).all()):
                raise AssertionError(f"{comp}: logits not finite")
            if comp == "dir2":
                ref = dict(y32=y32, y16=y16)
                err32 = rel16 = 0.0
            else:
                scale = float(ref["y32"].abs().max())
                err32 = check_close(f"{comp} f32 window vs dir2", y32,
                                    ref["y32"], 2e-4, 1e-4 * scale)
                rel16 = rel_l2(y16, ref["y16"])
                if not rel16 <= 1.5e-2:
                    raise AssertionError(f"{comp}: bf16 window logits vs "
                                         f"dir2 relative L2 {rel16}")
            ms = cuda_ms(lambda: model(x), 3)
            share = None
            if comp == "mxu":
                with scan_mxu.tally() as tl:
                    model(x)
                share = tl.share()
                n_mamba = sum(isinstance(m, MambaV3) for m in model.modules())

            def run():
                return sliding_window_inference(
                    case, ROI, model, overlap=0.5, sw_batch_size=1,
                    compute_dtype=torch.bfloat16)

            reset_counts()
            out = run()
            torch.cuda.synchronize()
            case_counts = launch_counts()
            if case_counts != expected_counts(**composition_counts(comp, 8,
                                                                   model)):
                raise AssertionError(f"{comp}: case launches {case_counts}")
            if not torch.isfinite(out).all():
                raise AssertionError(f"{comp}: case logits not finite")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            sec = statistics.median(times)
            log(f"composition {comp}: f32 window vs dir2 max abs err "
                f"{err32:.3e}, bf16 window vs dir2 relative L2 {rel16:.3e}; "
                f"{ms:.2f} ms/window; {sec:.4f} s/case (median of 3: "
                f"{', '.join(f'{t:.4f}' for t in times)}); launches per "
                f"window {counts}, per case {case_counts}" + (
                    "" if share is None else
                    f" (derived from the model: {n_mamba} MambaV3 x 3 "
                    "directions, one K7 each, per window; 8 windows per "
                    f"case); ratio-form share of the window {share:.4f}"))
            stats[comp] = dict(ms_per_window=ms, sec_per_case=sec,
                               counts=counts, case_counts=case_counts,
                               err32=err32, rel16=rel16, share=share)
            del model, out, y32, y16
            torch.cuda.empty_cache()
    return stats


def phase_composition_train():
    """The recipe train step (phase 7's) under each composition, in turn:
    s/step (median of 4 after one warm-up), peak memory, losses finite and
    falling, exact forward and backward launches per step; then the
    forward and backward ms of a stage-0 and a stage-1 Mamba layer run
    alone (where the compositions differ)."""
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.standard_normal(
            (2, 4, *ROI)).astype(np.float32)).cuda(),
        "label": torch.from_numpy(rng.integers(0, 4, (2, *ROI))).cuda()}
    stats = {}
    for comp in COMPOSITIONS:
        model = build_composition(comp, torch.bfloat16, remat="convs")
        state = create_train_state(
            model, learning_rate=poly_schedule(1e-2, 1000 * 250))
        fwd = composition_counts(comp, 1, model)
        per_step = expected_counts(**fwd, **{f"{k}_bwd": v
                                             for k, v in fwd.items()})
        losses, times = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(5):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = launch_counts()
            if counts != per_step:
                raise AssertionError(f"{comp} step {i}: launches {counts}, "
                                     f"expected {per_step}")
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{comp}: losses {losses} not finite or "
                                 "not falling")
        sec = statistics.median(times[1:])
        rows = module_split(model, batch["image"],
                            ["vit.stages.0.0", "vit.stages.1.0"])
        log(f"train step {comp}: {sec:.4f} s/step (median of 4 after a "
            f"warm-up: {', '.join(f'{t:.4f}' for t in times[1:])}); peak "
            f"{peak:.2f} GiB; losses {', '.join(f'{v:.5f}' for v in losses)}"
            f"; launches per step {counts}; alone: " + ", ".join(
                f"{n} fwd {f:.3f} ms bwd {b:.3f} ms" for n, f, b in rows))
        stats[comp] = dict(sec=sec, peak_gib=peak, counts=counts)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
    stats["mxu"]["layer_split"] = layer_split()
    return stats


def phase_core_groups():
    """K6 at N = 4 and N = 64 (groups of 16 states) vs its plain version,
    forward and backward, at CORE_N_SHAPE."""
    R, L, D = CORE_N_SHAPE
    T = scan_core.DEF_CHUNK
    rtol, atol = TOL[torch.float32]
    for n in (4, 64):
        g = torch.Generator(device=DEVICE).manual_seed(n)
        u = torch.randn(R, L, D, generator=g, device=DEVICE)
        delta = torch.nn.functional.softplus(
            0.5 * torch.randn(R, L, D, generator=g, device=DEVICE) - 2.0)
        A = -torch.exp(0.5 * torch.randn(D, n, generator=g, device=DEVICE))
        B = torch.randn(R, L, n, generator=g, device=DEVICE)
        C = torch.randn(R, L, n, generator=g, device=DEVICE)
        dy = torch.randn(R, L, D, generator=g, device=DEVICE)
        dlast = torch.randn(R, D, n, generator=g, device=DEVICE)
        y, st = scan_core._launch(u, delta, A, B, C, T)
        y_p, st_p = scan_core.selective_scan_core_ref(u, delta, A, B, C, T,
                                                      return_states=True)
        err = max(check_close(f"K6 N={n} y", y, y_p, rtol, atol),
                  check_close(f"K6 N={n} states", st, st_p, rtol, atol))
        leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
        before = scan_core.LAUNCHES, scan_core.BWD_LAUNCHES
        out, last = scan_core.selective_scan_kernel(*leaves,
                                                    return_last_state=True)
        torch.autograd.backward((out, last), (dy, dlast))
        groups = -(-n // 16)
        if (scan_core.LAUNCHES - before[0],
                scan_core.BWD_LAUNCHES - before[1]) != (groups, groups):
            raise AssertionError(f"K6 N={n}: launches per call")
        want = scan_core.selective_scan_core_bwd_ref(u, delta, A, B, C, dy,
                                                     dlast, T)
        for name, leaf, w in zip(CORE_GRADS, leaves, want):
            a = atol * max(1.0, float(w.abs().max())) \
                if name in ("dA", "dB", "dC") else atol
            err = max(err, check_close(f"K6 N={n} {name}", leaf.grad, w,
                                       rtol, a))
        ms = cuda_ms(lambda: scan_core._launch(u, delta, A, B, C, T), 5)
        log(f"K6 N={n} {CORE_N_SHAPE} ({groups} launch(es) of 16 states): "
            f"max_abs_err {err:.3e}, forward {ms:.4f} ms")
        del u, delta, A, B, C, dy, dlast, y, st, y_p, st_p, leaves, want
        torch.cuda.empty_cache()


def mxu_inputs(R, L, D, kind, seed):
    """K7's float32 operands: ``core_inputs``' ("model": deltas in the
    model's range, softplus of the dt-bias init plus a projection);
    "tripped": delta + 40, every unit in the step form (JAX's
    ``test_guard_routes_pathological_decay``); "mixed": delta + 2 on every
    third chunk of 128 steps, which trips there the units whose |A| is
    above ~2.3 and leaves the others, and the other chunks, in the ratio
    form; "spiked": delta + 40 on every third chunk, on which K6 and K7
    are held against float64 runs of their plain versions. (The spike
    leaves the next chunk a state ~40x larger that hardly decays, and
    float32 then loses ddelta to cancellation, in the plain versions as in
    the kernels: ``ddelta_report``.)"""
    u, delta, A, B, C = core_inputs(R, L, D, seed)
    t = (torch.arange(L, device=DEVICE) // scan_mxu.DEF_CHUNK) % 3 == 1
    if kind == "tripped":
        delta = delta + 40.0
    elif kind == "mixed":
        delta = delta + 2.0 * t[:, None]
    elif kind == "spiked":
        delta = delta + 40.0 * t[:, None]
    return u, delta, A, B, C


def tier_use(got, want, rtol, atol):
    """The largest share of its tolerance any value uses: max |got - want|
    / (atol + rtol |want|)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def mxu_plain(u, delta, A, B, C, width, dy=None, dlast=None, *, k6=False,
              f64=False):
    """K7's (with ``k6``, K6's) plain forward (y, chunk states) or, given
    dy and dlast, its plain backward (du, ddelta, dA, dB, dC: autograd of
    (y, last state)), over channel slices of ``width`` in turn: the
    channels are independent, so the slices' results go side by side, and
    dB, dC (sums over channels) are summed. In float32, or with ``f64`` in
    float64 (results returned in float32)."""
    ref = (scan_core.selective_scan_core_ref if k6
           else scan_mxu.selective_scan_mxu_core_ref)
    dt = torch.float64 if f64 else torch.float32
    parts = []
    for d0 in range(0, u.shape[-1], width):
        sl = slice(d0, d0 + width)
        ops = [t.to(dt) for t in (u[..., sl], delta[..., sl], A[sl], B, C)]
        if dy is None:
            parts.append([t.float() for t in ref(*ops, return_states=True)])
            continue
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ops]
            y, st = ref(*leaves, return_states=True)
            grads = torch.autograd.grad(
                (y, scan_core._last_state(st)), leaves,
                (dy[..., sl].to(dt), dlast[:, sl].to(dt)))
        parts.append([g.float() for g in grads])
    cat = lambda i, dim: torch.cat([q[i] for q in parts], dim)
    if dy is None:
        return cat(0, -1), cat(1, -1)
    return (cat(0, -1), cat(1, -1), cat(2, 0),
            sum(q[3] for q in parts), sum(q[4] for q in parts))


def mxu_plain_run(direction, R, L, D, fn_of_width):
    """Run a plain K7 (or K6) call over as few channel slices as keep its
    predicted peak (``MXU_PLAIN_BPE[direction]``) under 3/4 of the free
    memory; returns (its
    result, its ms by CUDA events, the slice width, the measured peak
    bytes per element, which then replaces the prediction)."""
    torch.cuda.empty_cache()
    budget = PLAIN_BWD_SHARE * torch.cuda.mem_get_info()[0]
    slices = math.ceil(MXU_PLAIN_BPE[direction] * R * L * D * N / budget)
    width = math.ceil(D / slices)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn_of_width(width)
    end.record()
    end.synchronize()
    bpe = (torch.cuda.max_memory_allocated() - base) / (R * L * width * N)
    MXU_PLAIN_BPE[direction] = 1.25 * bpe   # with headroom for the next
    return out, start.elapsed_time(end), width, bpe


def phase_mxu(results):
    """K7 forward and backward vs their plain versions at the LM prefill's
    shape, a ragged one and SegMamba's stage 0 (R = 1 and 2), on four
    kinds of input (on "spiked", K7 and K6 against float64 runs of their
    plain versions); times beside K6's on the same inputs; fills
    ``results``."""
    rtol, atol = TOL[torch.float32]
    for shape_name, (R, L, D) in MXU_SHAPES.items():
        T, S = scan_mxu._geometry(L)
        reps = 5 if L * D > 1e7 else 10
        k6 = None
        for kind in MXU_KINDS:
            f64 = kind == "spiked"
            key = lambda d: d + ("64" if f64 else "")
            u, delta, A, B, C = mxu_inputs(R, L, D, kind, seed=L + D + R)
            tag = f"K7 {shape_name} {(R, L, D)} {kind}"
            if f64:
                tag += " vs float64"
            jax_bound = scan_mxu.block_drop(delta, A, S)
            with scan_mxu.tally() as tl:
                y, st = scan_mxu._launch(u, delta, A, B, C, T, S, True)
            (y_p, st_p), plain_f, width_f, bpe_f = mxu_plain_run(
                key("fwd"), R, L, D,
                lambda w: mxu_plain(u, delta, A, B, C, w, f64=f64))
            err_f = max(check_close(f"{tag} y", y, y_p, rtol, atol),
                        check_close(f"{tag} states", st, st_p, rtol, atol),
                        check_close(f"{tag} last state",
                                    scan_core._last_state(st),
                                    scan_core._last_state(st_p), rtol, atol))
            use = max(tier_use(y, y_p, rtol, atol),
                      tier_use(st, st_p, rtol, atol))
            del y, y_p, st_p

            # backward through the public wrapper and its autograd Function
            g = torch.Generator(device=DEVICE).manual_seed(L + 1)
            dy = torch.randn(R, L, D, generator=g, device=DEVICE)
            dlast = torch.randn(R, D, N, generator=g, device=DEVICE)
            leaves = [t.detach().requires_grad_()
                      for t in (u, delta, A, B, C)]
            before = scan_mxu.LAUNCHES, scan_mxu.BWD_LAUNCHES
            out, last = scan_mxu.selective_scan_mxu(*leaves,
                                                    return_last_state=True)
            if out.grad_fn is None or last.grad_fn is None:
                raise AssertionError(f"{tag}: CUDA forward with "
                                     "requires_grad inputs has no grad_fn")
            torch.autograd.backward((out, last), (dy, dlast))
            if (scan_mxu.LAUNCHES - before[0],
                    scan_mxu.BWD_LAUNCHES - before[1]) != (1, 1):
                raise AssertionError(f"{tag}: launches per call")
            got = [t.grad for t in leaves]
            del out, last, leaves
            want, plain_b, width_b, bpe_b = mxu_plain_run(
                key("bwd"), R, L, D,
                lambda w: mxu_plain(u, delta, A, B, C, w, dy, dlast,
                                    f64=f64))
            err_b = 0.0
            for name, gk, w in zip(CORE_GRADS, got, want):
                a = atol * max(1.0, float(w.abs().max())) \
                    if name in ("dA", "dB", "dC") else atol
                if f64 and name == "ddelta":   # held by ddelta_report
                    ddelta = ddelta_report(tag, gk, w, mxu_plain_run(
                        "bwd", R, L, D, lambda w_: mxu_plain(
                            u, delta, A, B, C, w_, dy, dlast))[0][1])
                    continue
                err_b = max(err_b, check_close(f"{tag} {name}", gk, w, rtol,
                                               a))
                use = max(use, tier_use(gk, w, rtol, a))
            del got, want
            if f64:
                ddelta6 = spiked_k6(tag, u, delta, A, B, C, dy, dlast, R, L,
                                    D)

            ms_f = cuda_ms(lambda: scan_mxu._launch(u, delta, A, B, C, T, S,
                                                    True), reps)
            ms_b = cuda_ms(lambda: scan_mxu._launch_bwd(
                u, delta, A, B, C, dy, dlast, st, T, S, True), reps)
            if k6 is None:   # K6 on the same inputs, the yardstick
                st6 = scan_core._launch(u, delta, A, B, C,
                                        scan_core.DEF_CHUNK)[1]
                k6 = (cuda_ms(lambda: scan_core._launch(
                          u, delta, A, B, C, scan_core.DEF_CHUNK), reps),
                      cuda_ms(lambda: scan_core._launch_bwd(
                          u, delta, A, B, C, dy, dlast, st6,
                          scan_core.DEF_CHUNK), reps))
                del st6
            bounds = core_bound("fwd", R, L, D), core_bound("bwd", R, L, D)
            log(f"kernel {tag}: share of the f32 tier used {use:.4f}; "
                f"ratio-form share {tl.share():.4f} "
                f"({tl.ratio} of {tl.ratio + tl.step} units; JAX's "
                f"call-wide bound {jax_bound:.1f}: "
                f"{'K6' if jax_bound >= scan_mxu.MAX_BLOCK_DROP else 'K7'} "
                "for the whole call there); fwd "
                f"max_abs_err {err_f:.3e}, K7 {ms_f:.4f} ms, K6 "
                f"{k6[0]:.4f} ms, plain {plain_f:.4f} ms (slices of "
                f"{width_f}, {bpe_f:.1f} B/elem), bound {bounds[0][0]:.4f} "
                f"ms ({bounds[0][1]}); bwd max_abs_err {err_b:.3e}, K7 "
                f"{ms_b:.4f} ms, K6 {k6[1]:.4f} ms, plain {plain_b:.4f} ms "
                f"(slices of {width_b}, {bpe_b:.1f} B/elem), bound "
                f"{bounds[1][0]:.4f} ms ({bounds[1][1]})")
            for direction, err, ms, k6_ms, plain_ms, (bound, bound_by) in (
                    ("fwd", err_f, ms_f, k6[0], plain_f, bounds[0]),
                    ("bwd", err_b, ms_b, k6[1], plain_b, bounds[1])):
                results.append(dict(
                    direction=direction, shape=shape_name, kind=kind,
                    max_abs_err=err, ms=ms, k6_ms=k6_ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=bound_by, share=tl.share(),
                    jax_bound=jax_bound, tier_use=use,
                    ddelta=dict(K7=ddelta, K6=ddelta6) if f64 else None))
            del u, delta, A, B, C, st, dy, dlast
            torch.cuda.empty_cache()
    jobs = [(direction, suffix, shape) for direction in ("fwd", "bwd")
            for suffix, shape in (("", "stage0_r2"),
                                  ("_prefill", "prefill"))]
    for (direction, _, shape), parts in zip(jobs, breakdowns_in_children([
            (f"mxu_{d}{x}", f"K7 {d} {sh} model") for d, x, sh in jobs])):
        row = next(r for r in results if r["direction"] == direction
                   and r["shape"] == shape and r["kind"] == "model")
        row["device_ms"] = None if parts is None else sum(parts.values())


def ddelta_report(tag, got, want, plain32):
    """ddelta on the spiked input against float64: the share of the f32
    tier that the kernel and the plain float32 version use, and how many
    values exceed it. Held to ``DDELTA_PLAIN_MULT`` times the plain float32
    version's share, not to the tier: after a spiked chunk the state is
    ~40x larger and ddelta = sum_n A g x a + u sum_n g B cancels terms
    many thousand times larger than the result, so float32 rounding of x
    and g alone moves it by more than the tier, in the plain float32
    version as in the kernels."""
    rtol, atol = TOL[torch.float32]
    want = want.double()
    over = lambda g: int(((g.double() - want).abs()
                          > atol + rtol * want.abs()).sum())
    rep = dict(share=tier_use(got, want, rtol, atol), over=over(got),
               plain32_share=tier_use(plain32, want, rtol, atol),
               plain32_over=over(plain32), n=want.numel())
    limit = DDELTA_PLAIN_MULT * rep["plain32_share"]
    log(f"{tag} ddelta vs float64: kernel uses {rep['share']:.3f} of the "
        f"f32 tier ({rep['over']} of {rep['n']} values over), the plain "
        f"float32 version {rep['plain32_share']:.3f} ({rep['plain32_over']}"
        f" over); held to {DDELTA_PLAIN_MULT}x the plain share, "
        f"{limit:.3f}")
    if not rep["share"] <= limit:
        raise AssertionError(f"{tag} ddelta: {rep['share']:.3f} of the f32 "
                             f"tier against float64, over {limit:.3f}")
    return rep


def spiked_k6(tag, u, delta, A, B, C, dy, dlast, R, L, D):
    """K6 on phase 14's spiked input, forward (y, chunk states) and
    backward (du, dA, dB, dC; ddelta held by ``ddelta_report``),
    against a float64 run of its plain version at the f32 tier. Returns
    the ddelta report."""
    rtol, atol = TOL[torch.float32]
    T = scan_core.DEF_CHUNK
    tag = tag.replace("K7", "K6")
    y, st = scan_core._launch(u, delta, A, B, C, T)
    (y_p, st_p), *_ = mxu_plain_run(
        "k6_fwd64", R, L, D,
        lambda w: mxu_plain(u, delta, A, B, C, w, k6=True, f64=True))
    check_close(f"{tag} y", y, y_p, rtol, atol)
    check_close(f"{tag} states", st, st_p, rtol, atol)
    use = max(tier_use(y, y_p, rtol, atol), tier_use(st, st_p, rtol, atol))
    del y, y_p, st_p
    got = scan_core._launch_bwd(u, delta, A, B, C, dy, dlast, st, T)
    want, *_ = mxu_plain_run(
        "k6_bwd64", R, L, D,
        lambda w: mxu_plain(u, delta, A, B, C, w, dy, dlast, k6=True,
                            f64=True))
    for name, gk, w in zip(CORE_GRADS, got, want):
        a = atol * max(1.0, float(w.abs().max())) \
            if name in ("dA", "dB", "dC") else atol
        if name == "ddelta":
            rep = ddelta_report(tag, gk, w, mxu_plain_run(
                "k6_bwd", R, L, D, lambda w_: mxu_plain(
                    u, delta, A, B, C, w_, dy, dlast, k6=True))[0][1])
            continue
        check_close(f"{tag} {name}", gk, w, rtol, a)
        use = max(use, tier_use(gk, w, rtol, a))
    log(f"kernel {tag}: share of the f32 tier used {use:.4f} (y, states, "
        "du, dA, dB, dC)")
    del got, want, st
    torch.cuda.empty_cache()
    return rep


def conv_bound(direction, s, cin, cout):
    """Least time (ms) of one bf16 conv call at batch 1, s^3 positions, and
    what bounds it: 2 s^3 27 Cin Cout products over the bf16 tensor-core
    rate, against each input read once and each output written once over
    the HBM rate. fwd: x, w read, y written (bf16); dw: x, dy read (bf16),
    dw written (float32)."""
    pos = s ** 3
    flops = 2 * pos * 27 * cin * cout
    if direction == "fwd":
        nbytes = 2 * pos * (cin + cout) + 2 * 27 * cin * cout
    else:
        nbytes = 2 * pos * (cin + cout) + 4 * 27 * cin * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv_inputs(shape, dtype, seed):
    """x (B, D, H, W, Cin) and dy (..., Cout) unit normal in ``dtype``, w
    (3, 3, 3, Cin, Cout) float32 at fan-in scale."""
    B, D, H, W, cin, cout = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    return (rn(B, D, H, W, cin).to(dtype),
            rn(3, 3, 3, cin, cout) * (27 * cin) ** -0.5,
            rn(B, D, H, W, cout).to(dtype))


def conv_hold(tag, x, w, dy, y, dx, dw):
    """Hold K9's y and dx (the forward kernel) at x.dtype's tier and dw at
    the f32 tier, its absolute part scaled by max(1, max|plain|), against
    the plain versions on the same inputs. Returns (the forward kernel's
    largest absolute error, dw's)."""
    rtol, atol = TOL[x.dtype]
    f_rtol, f_atol = TOL[torch.float32]
    with torch.no_grad():
        err_f = max(
            check_close(f"{tag} y", y, conv3d.conv3d_k3s1_ref(x, w), rtol,
                        atol),
            check_close(f"{tag} dx", dx,
                        conv3d.conv3d_k3s1_ref(dy, conv3d._flip_w(w)), rtol,
                        atol))
        want_dw = conv3d.conv3d_k3s1_dw_ref(x, dy)
        err_dw = check_close(f"{tag} dw", dw, want_dw, f_rtol,
                             f_atol * max(1.0, float(want_dw.abs().max())))
    return err_f, err_dw


def conv_run(x, w, dy):
    """``conv3d_k3s1`` forward and backward through its autograd Function:
    (y, dx, dw)."""
    lx, lw = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = conv3d.conv3d_k3s1(lx, lw)
    y.backward(dy)
    return y.detach(), lx.grad, lw.grad


def phase_conv(results):
    """K9 (``conv3d``): kernel vs plain at small ragged shapes in float32
    and bfloat16; then its main path, ``conv3d_k3s1`` forward and backward
    once at each of ``benchmarks/bench_conv.py``'s shapes (bf16, batch 1)
    with the counters read around it, and y, dx and dw of that run held
    against the plain versions (``conv_hold``); then, per shape, the
    kernel's forward and dw times, forward + backward through the autograd
    Function, the plain versions' times and cuDNN's (``F.conv3d`` on
    channels_last_3d views, ``torch.nn.grad.conv3d_weight``, and their
    forward + backward), CUDA events, median of 5 after a warm-up, beside
    the bounds. Fills ``results``; returns (the main path's counts, each
    kernel's largest absolute error: {"fwd": .., "dw": ..})."""
    errs = dict(fwd=0.0, dw=0.0)
    for shape in CONV_CHECKS:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = conv_inputs(shape, dtype, seed=sum(shape))
            e = conv_hold(f"K9 {shape} {str(dtype)[6:]}", x, w, dy,
                          *conv_run(x, w, dy))
            errs = dict(fwd=max(errs["fwd"], e[0]), dw=max(errs["dw"], e[1]))
    log(f"K9 checks at {len(CONV_CHECKS)} ragged shapes, float32 and "
        f"bfloat16: max_abs_err forward {errs['fwd']:.3e}, dw "
        f"{errs['dw']:.3e}")
    torch.cuda.empty_cache()

    bf16 = torch.bfloat16
    runs = []
    reset_counts()
    for s, cin, cout in CONV_SHAPES:
        x, w, dy = conv_inputs((1, s, s, s, cin, cout), bf16, seed=s + cin)
        runs.append((x, w, dy, *conv_run(x, w, dy)))
    torch.cuda.synchronize()
    counts = launch_counts()
    n = len(CONV_SHAPES)
    if counts != expected_counts(conv3d=2 * n, conv3d_dw=n):
        raise AssertionError(f"K9 main path launches {counts}")
    for (s, cin, cout), run in zip(CONV_SHAPES, runs):
        e = conv_hold(f"K9 {s}^3 {cin}->{cout} bfloat16", *run)
        log(f"K9 main path {s}^3 {cin}->{cout}: y and dx max_abs_err "
            f"{e[0]:.3e}, dw {e[1]:.3e} (max|dw| "
            f"{float(run[-1].abs().max()):.1f})")
        errs = dict(fwd=max(errs["fwd"], e[0]), dw=max(errs["dw"], e[1]))
    del runs, run
    torch.cuda.empty_cache()

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True    # cuDNN at its best algorithm
    try:
        for s, cin, cout in CONV_SHAPES:
            results.append(conv_times(s, cin, cout))
    finally:
        torch.backends.cudnn.benchmark = bench
    device = conv_device_in_child()
    for row in results:
        dev = (device or {}).get(row["shape"], {})
        for kind, pre in (("fwd", ""), ("dw", "dw_"), ("library_fwd", ""),
                          ("library_dw", "dw_")):
            key = (f"{pre}library_device_ms" if kind.startswith("library")
                   else f"{pre}device_ms")
            row[key] = dev.get(kind)
        log(f"K9 {row['shape']} device time (torch.profiler): fwd "
            f"{ms_or_none('.4f', row['device_ms'])} ms (cuDNN "
            f"{ms_or_none('.4f', row['library_device_ms'])}), dw "
            f"{ms_or_none('.4f', row['dw_device_ms'])} ms (cuDNN "
            f"{ms_or_none('.4f', row['dw_library_device_ms'])})")

    # the twin of benchmarks/bench_conv.py, its main as a user runs it
    reset_counts()
    bench_conv.main([])
    twin = launch_counts()
    apps = [1 + 3 * (5 if s <= 64 else 3) for s, _, _ in bench_conv.SHAPES]
    if twin != expected_counts(conv3d=3 * sum(apps), conv3d_dw=sum(apps)):
        raise AssertionError(f"bench_conv main: launches {twin}")
    log(f"bench_conv main: launches {twin}")
    return dict(counts, twin_conv3d=twin["conv3d"],
                twin_conv3d_dw=twin["conv3d_dw"]), errs


def conv_device_breakdown():
    """``--breakdown conv``: the device ms of one call of each of
    ``conv_calls`` at each ``CONV_SHAPES`` shape, all in the one profiler
    session of this process (a later session in a long process has come
    back empty). The calls run in turn after a warm-up (cuDNN's benchmark
    search included), each followed by a marker kernel
    (``torch.cuda._sleep``); the device kernels, in start order, are cut
    at the markers and each segment summed. Returns {shape: {call: ms}},
    or {} when the profiler recorded no device kernel or the segments do
    not match the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.benchmark = True
    calls = []
    for s, cin, cout in CONV_SHAPES:
        x, w, dy = conv_inputs((1, s, s, s, cin, cout), torch.bfloat16,
                               seed=s + cin + 1)
        calls += [(f"{s}^3 {cin}->{cout}", k, fn)
                  for k, fn in conv_calls(x, w, dy).items()]
    for _, _, fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, _, fn in calls:
            fn()
            torch.cuda._sleep(2000)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    segments, cur = [], 0.0
    for e in kernels:
        if "spin_kernel" in e.name:
            segments.append(cur / 1e3)
            cur = 0.0
        else:
            cur += e.time_range.elapsed_us()
    if len(segments) != len(calls):
        return {}
    out = {}
    for (shape, kind, _), ms in zip(calls, segments):
        out.setdefault(shape, {})[kind] = ms
    return out


def conv_device_in_child(tries=2):
    """``conv_device_breakdown`` in a fresh process (as
    ``breakdown_in_child``), taken again when it comes back empty; None
    (not measured) after ``tries`` empty ones."""
    for attempt in range(1, tries + 1):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--breakdown",
             "conv"], capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"breakdown conv: child failed "
                               f"({proc.returncode}): {proc.stderr[-2000:]}")
        out = json.loads(lines[-1])
        if out:
            return out
        log(f"breakdown conv: process {attempt} recorded no device kernel "
            "(or not one segment per call)")
    log("breakdown conv: device time not measured")
    return None


def conv_library_views(x, w, dy):
    """cuDNN's operands for a K9 call: x and dy as channels_last_3d views,
    w as (Cout, Cin, 3, 3, 3) channels_last_3d bf16."""
    ncdhw = lambda t: t.permute(0, 4, 1, 2, 3)
    wc = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    return ncdhw(x), wc, ncdhw(dy)


def conv_calls(x, w, dy):
    """The four calls phase 15 times and profiles on one shape's inputs:
    K9's forward and dw kernels and cuDNN's forward and weight gradient."""
    xc, wc, dyc = conv_library_views(x, w, dy)
    return {"fwd": lambda: conv3d._launch(x, w),
            "dw": lambda: conv3d._launch_dw(x, dy),
            "library_fwd": lambda: torch.nn.functional.conv3d(
                xc, wc, padding=1),
            "library_dw": lambda: torch.nn.grad.conv3d_weight(
                xc, wc.shape, dyc, padding=1)}


def conv_times(s, cin, cout):
    """One ``CONV_SHAPES`` row: times of the kernels, the plain versions
    and cuDNN, and the bounds."""
    x, w, dy = conv_inputs((1, s, s, s, cin, cout), torch.bfloat16,
                           seed=s + cin + 1)
    xc, wc, dyc = conv_library_views(x, w, dy)
    calls = conv_calls(x, w, dy)
    tag = f"K9 {s}^3 {cin}->{cout}"

    def fwd_bwd():
        lx = x.detach().requires_grad_()
        lw = w.detach().requires_grad_()
        conv3d.conv3d_k3s1(lx, lw).backward(dy)

    def lib_fwd_bwd():
        lx = xc.detach().requires_grad_()
        lw = wc.detach().requires_grad_()
        torch.nn.functional.conv3d(lx, lw, padding=1).backward(dyc)

    reps = 5
    row = dict(
        shape=f"{s}^3 {cin}->{cout}",
        ms=cuda_ms(calls["fwd"], reps),
        dw_ms=cuda_ms(calls["dw"], reps),
        fwd_bwd_ms=cuda_ms(fwd_bwd, reps),
        library_ms=cuda_ms(calls["library_fwd"], reps),
        dw_library_ms=cuda_ms(calls["library_dw"], reps),
        library_fwd_bwd_ms=cuda_ms(lib_fwd_bwd, reps),
        plain_ms=cuda_ms(lambda: conv3d.conv3d_k3s1_ref(x, w), reps),
        dw_plain_ms=cuda_ms(lambda: conv3d.conv3d_k3s1_dw_ref(x, dy), reps))
    row["bound_ms"], row["bound_by"] = conv_bound("fwd", s, cin, cout)
    row["dw_bound_ms"], row["dw_bound_by"] = conv_bound("dw", s, cin, cout)
    log(f"kernel {tag} (bf16): fwd {row['ms']:.4f} ms (cuDNN "
        f"{row['library_ms']:.4f}, ratio {row['ms'] / row['library_ms']:.3f}"
        f"; plain {row['plain_ms']:.4f}; bound {row['bound_ms']:.4f} "
        f"{row['bound_by']}, share {row['bound_ms'] / row['ms']:.3f}); dw "
        f"{row['dw_ms']:.4f} ms (cuDNN {row['dw_library_ms']:.4f}, ratio "
        f"{row['dw_ms'] / row['dw_library_ms']:.3f}; plain "
        f"{row['dw_plain_ms']:.4f}; bound {row['dw_bound_ms']:.4f} "
        f"{row['dw_bound_by']}, share {row['dw_bound_ms'] / row['dw_ms']:.3f}"
        f"); fwd + bwd {row['fwd_bwd_ms']:.4f} ms (cuDNN "
        f"{row['library_fwd_bwd_ms']:.4f}, ratio "
        f"{row['fwd_bwd_ms'] / row['library_fwd_bwd_ms']:.3f})")
    del x, w, dy, xc, dyc, wc, calls
    torch.cuda.empty_cache()
    return row


def phase_state_groups():
    """``MambaV3(d_state=4)`` and ``(d_state=32)`` at SegMamba's stage-0
    width (d_model 48) under each kernel composition on the card, forward
    and backward through the kernels (ceil(N / 16) launches per scan call,
    counted), against the same module on the plain scans: output at the
    f32 tier, every parameter gradient at the f32 tier with the absolute
    part scaled by max(1, max|plain|); the kernel path's forward and
    backward ms."""
    b, L, d_model, S = GROUP_SHAPE
    rtol, atol = TOL[torch.float32]
    h = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, L, d_model)).astype(np.float32)).to(DEVICE)
    for n, (name, (impl, slice_kernel, per)) in itertools.product(
            GROUP_D_STATES, GROUP_COMPOSITIONS.items()):
        m = MambaV3(d_model, d_state=n, nslices=S, scan_impl=impl,
                    slice_kernel=slice_kernel,
                    generator=torch.Generator().manual_seed(n), device=DEVICE)
        tag = f"MambaV3 d_state={n} {name}"

        def run():
            m.zero_grad(set_to_none=True)
            out = m(h)
            out.square().mean().backward()
            return out.detach(), {k: p.grad for k, p in m.named_parameters()}

        reset_counts()
        out, grads = run()
        torch.cuda.synchronize()
        groups = -(-n // 16)
        fwd = {k: v * groups for k, v in per.items()}
        bwd = {(k.replace("slice", "slice_bwd") if k.endswith("slice")
                else f"{k}_bwd"): v for k, v in fwd.items()}
        counts = launch_counts()
        if counts != expected_counts(**fwd, **bwd):
            raise AssertionError(f"{tag}: launches {counts}")
        with plain_scans():
            out_p, grads_p = run()
        err = check_close(f"{tag} out", out, out_p, rtol, atol)
        for k, w in grads_p.items():
            err = max(err, check_close(f"{tag} d{k}", grads[k], w, rtol,
                                       atol * max(1.0,
                                                  float(w.abs().max()))))
        ms = cuda_ms(run, 3)
        log(f"{tag} {(b, L, d_model)}: kernel path vs plain max_abs_err "
            f"{err:.3e} (output and {len(grads)} gradients); forward + "
            f"backward {ms:.3f} ms; launches {counts}")
        del m, out, grads, out_p, grads_p
        torch.cuda.empty_cache()


def probe_bound(kind, R, L, D, dtype):
    """Least time (ms) of one K10 / K11 call and what bounds it
    (``bound_of``): u, dt, z read and out written (R L D each), B, C read
    (R L N), A, D, bias. Float32 operations per (step, channel, state):
    "noshift" 31 (delta A, delta u B, 7 rounds of a b and its
    multiply-add, 6 squarings a a, C x and its add), "nohs" 5 (delta A,
    delta u B, a b, C x and its add), "flat" (K2's function) 7 as
    ``scan_bound``'s; per (step, channel) 14 as there. Transcendental
    results: one exp per (step, channel, state), softplus's and the gate's
    per (step, channel)."""
    es = 2 if dtype == torch.bfloat16 else 4
    seq, bc = R * L * D, R * L * N
    nbytes = 4 * seq * es + 2 * bc * es + (D * N + 2 * D) * 4
    per_state = {"noshift": 31, "nohs": 5, "flat": 7}[kind]
    return bound_of(nbytes, seq * (per_state * N + 14), seq * (N + 2))


def probe_call(kind, a, plain=False):
    """K10 ("noshift", "nohs") or K11 ("flat") on ``a``'s operands, or its
    plain version."""
    args = (a["u"], a["dt"], a["z"], a["A"], a["B"], a["C"], a["D"],
            a["bias"])
    if kind == "flat":
        fn = bench_scan_flat.flat_call_ref if plain else \
            bench_scan_flat.flat_call
        return fn(*args)
    fn = bench_scan_lb.variant_call_ref if plain else \
        bench_scan_lb.variant_call
    return fn(*args, kind)


def probe_plain(kind, a, width):
    """The plain version over channel slices of ``width`` in turn (the
    channels are independent; B and C are shared)."""
    dim = a["u"].shape[-1]
    parts = []
    for d0 in range(0, dim, width):
        sl = slice(d0, d0 + width)
        part = dict(a, **{k: a[k][..., sl] for k in ("u", "dt", "z")},
                    **{k: a[k][sl] for k in ("A", "D", "bias")})
        parts.append(probe_call(kind, part, plain=True))
    return torch.cat(parts, -1)


def probe_width(kind, R, L, D):
    """Channels per slice of the plain version: its peak bytes per (row,
    step, channel), measured on a float32 call of 4096 steps, times the
    full call's, kept under PLAIN_BWD_SHARE of the free memory."""
    a = scan_inputs(R, 4096, D, torch.float32, seed=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probe_call(kind, a, plain=True)
    torch.cuda.synchronize()
    per = (torch.cuda.max_memory_allocated() - base) / (R * 4096 * D)
    del a
    torch.cuda.empty_cache()
    budget = PLAIN_BWD_SHARE * torch.cuda.mem_get_info()[0]
    return math.ceil(D / math.ceil(per * R * L * D / budget)), per


def probe_counts():
    return {"scan_lb": bench_scan_lb.LAUNCHES,
            "scan_flat": bench_scan_flat.LAUNCHES}


def breakdown_call(name):
    """The call whose device time ``--breakdown NAME`` splits by kernel:
    phase 2's stage-0 bf16 calls ("dir_reverse", "fused_gate") on phase 2's
    inputs; phase 5's stage-0 bf16 backward kernel calls ("bwd_" + a
    variant); phase 11's K5 backward at stage 0, R = 2, bf16
    ("bwd_slice"); phase 9's K6 backward at the prefill shape
    ("bwd_core"); phase 14's K7 calls ("mxu_fwd", "mxu_bwd", and at the
    prefill shape "mxu_fwd_prefill", "mxu_bwd_prefill"; "k6_..." K6 on the
    same inputs: ``mxu_breakdown_call``); phase 11's bf16 forward + acc +
    gate K8 calls ("proj_fwd" at R = 2, "proj_bwd" at R = 1:
    ``proj_call``); phase 13's stage-0 layer ("mxu_layer", "dir2_layer",
    "proj_layer": ``layer_call``); or phase 17's R = 1 bf16 calls of K2
    ("k2"), K10 ("noshift", "nohs") and K11 ("flat") on phase 17's
    inputs."""
    if name in ("mxu_layer", "dir2_layer", "proj_layer"):
        return layer_call(name[:-len("_layer")])
    if name in ("proj_fwd", "proj_bwd"):
        return proj_call(name[5:], 2 if name == "proj_fwd" else 1)
    if name.startswith(("mxu_", "k6_")):
        return mxu_breakdown_call(name)
    if name in VARIANTS:
        R, L, D = SHAPES["stage0"]
        a = scan_inputs(R, L, D, torch.bfloat16, seed=L + D)
        return variant_calls(name, a)[0]
    if name.startswith("bwd_") and name[4:] in VARIANTS:
        return bwd_kernel_call(name[4:], *bwd_inputs(
            *TRAIN_SHAPES["stage0"], torch.bfloat16))
    if name == "bwd_slice":
        return slice_bwd_call(2, SLICE_SHAPES["stage0"], torch.bfloat16)
    if name == "bwd_core":
        return core_bwd_call(*CORE_SHAPES["prefill"])
    L, D = PROBE_SHAPE
    a = scan_inputs(1, L, D, torch.bfloat16, seed=L + D + 17 + 1)
    if name == "k2":
        return lambda: scan_fused.mamba_scan_fused(
            a["u"], a["dt"], a["z"], a["A"], a["B"], a["C"], a["D"],
            a["bias"])
    return functools.partial(probe_call, name, a)


def mxu_breakdown_call(name):
    """``--breakdown {mxu|k6}_{fwd|bwd}[_prefill]``: one K7 call (K6's with
    "k6") of phase 14 on its "model" input, at stage 0 R = 2 or with
    "_prefill" at the LM prefill shape; the backward from the forward's
    chunk states, with phase 14's dy and dlast."""
    kern, direction, *shape = name.split("_")
    R, L, D = MXU_SHAPES["prefill" if shape == ["prefill"] else "stage0_r2"]
    T, S = scan_mxu._geometry(L)
    u, delta, A, B, C = mxu_inputs(R, L, D, "model", seed=L + D + R)
    if kern == "mxu":
        fwd = lambda: scan_mxu._launch(u, delta, A, B, C, T, S, True)
    else:
        fwd = lambda: scan_core._launch(u, delta, A, B, C,
                                        scan_core.DEF_CHUNK)
    if direction == "fwd":
        return fwd
    g = torch.Generator(device=DEVICE).manual_seed(L + 1)
    dy = torch.randn(R, L, D, generator=g, device=DEVICE)
    dlast = torch.randn(R, D, N, generator=g, device=DEVICE)
    st = fwd()[1]
    if kern == "mxu":
        return lambda: scan_mxu._launch_bwd(u, delta, A, B, C, dy, dlast, st,
                                            T, S, True)
    return lambda: scan_core._launch_bwd(u, delta, A, B, C, dy, dlast, st,
                                         scan_core.DEF_CHUNK)


def layer_call(comp):
    """``--breakdown {mxu|dir2|proj}_layer``: phase 13's stage-0 Mamba
    layer (``vit.stages.0.0`` of the bf16 train-step model under
    composition ``comp``), forward and backward on the input it sees in the
    recipe batch's forward."""
    image = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, *ROI)).astype(np.float32)).cuda()
    model = build_composition(comp, torch.bfloat16, remat="convs")
    mod = dict(model.named_modules())["vit.stages.0.0"]
    seen = []
    hook = mod.register_forward_pre_hook(
        lambda m, args: seen.extend(t.detach() for t in args))
    with torch.no_grad():
        model(image)
    hook.remove()
    args = [t.clone().requires_grad_() for t in seen]
    del image

    def run():
        out = _call(mod, False, *args)
        out.backward(torch.ones_like(out))
    return run


def layer_split():
    """Phase 13's stage-0 layer (forward + backward) by kernel name under
    "mxu", "dir2" and "proj", each profile in a fresh process: K7's two
    kernels against the rest of the mxu layer (the per-direction glue),
    dir2's scan kernels against the rest of its layer, K8's two kernels
    against the rest of the proj layer. Returns {comp: {"total", "scan",
    "rest"} device ms} (None where not measured)."""
    out = {}
    scans = (("mxu", ("mxu_fwd_kernel", "mxu_bwd_kernel")),
             ("dir2", ("scan_fwd_kernel", "scan_bwd_kernel")),
             ("proj", ("proj_fwd_kernel", "proj_bwd_kernel")))
    for (comp, scan), parts in zip(scans, breakdowns_in_children([
            (f"{c}_layer", f"stage-0 layer fwd + bwd {c}")
            for c, _ in scans])):
        if parts is None:
            out[comp] = None
            continue
        total = sum(parts.values())
        sc = sum(v for k, v in parts.items() if k in scan)
        out[comp] = dict(total=total, scan=sc, rest=total - sc)
    if out["mxu"] is not None and out["dir2"] is not None:
        m, d = out["mxu"], out["dir2"]
        log(f"stage-0 layer fwd + bwd, device: mxu {m['total']:.4f} ms = "
            f"K7 {m['scan']:.4f} + the rest {m['rest']:.4f}; dir2 "
            f"{d['total']:.4f} ms = scans {d['scan']:.4f} + the rest "
            f"{d['rest']:.4f}; mxu's extra {m['total'] - d['total']:.4f} ms "
            f"= scans {m['scan'] - d['scan']:.4f} + the per-direction glue "
            f"{m['rest'] - d['rest']:.4f}")
    if out["proj"] is not None and out["dir2"] is not None:
        q, d = out["proj"], out["dir2"]
        log(f"stage-0 layer fwd + bwd, device: proj {q['total']:.4f} ms = "
            f"K8 {q['scan']:.4f} + the rest {q['rest']:.4f}; proj - dir2 "
            f"{q['total'] - d['total']:.4f} ms = scans "
            f"{q['scan'] - d['scan']:.4f} + the rest "
            f"{q['rest'] - d['rest']:.4f}")
    return out


def breakdown_child_main(name):
    """``--breakdown NAME``: the one profiler session of this process, a
    warm-up call in its warm-up step and one call in its active step;
    prints {kernel name: device ms} (empty when the profiler recorded no
    device kernel) as the last line. With ``GPU_LOCK_ENV`` set the child
    holds that file's lock from its inputs to the end of the profiled call:
    children started together import, make their CUDA contexts and start
    their profilers (none runs a kernel) in parallel, use the card one at
    a time, and read their traces after letting go of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.empty(1, device="cuda")          # the context; no kernel runs
    lock_path = os.environ.get(GPU_LOCK_ENV)
    lock = open(lock_path, "a") if lock_path else None
    if name == "conv":
        if lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
        print(json.dumps(conv_device_breakdown()), flush=True)
        return
    kernels = []

    def ready(prof):   # the kernels; not the step's own device annotation
        kernels.extend(e for e in prof.key_averages()
                       if getattr(e, "device_type", None) == DeviceType.CUDA
                       and e.self_device_time_total > 0
                       and not e.key.startswith("ProfilerStep"))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        if lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
        fn = breakdown_call(name)
        fn()                                  # warm-up (not recorded)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        if lock:
            lock.close()                      # the card is free again
        prof.step()
    print(json.dumps(kernel_parts(kernels)), flush=True)


def breakdowns_in_children(jobs, tries=2):
    """Device time of one call by kernel name for each ``(name, tag)`` of
    ``jobs``, each profile taken in a fresh process of its own (the
    libraries load from ``_build/`` without a compile) as that process's
    only profiler session: on the H100 a later session in one process has
    come back without the card's kernels (in this script's own process at
    phase 2's second breakdown, and after phase 7's step profile). The
    processes start together and take turns on the card under a file lock
    (``breakdown_child_main``), so their start-up overlaps and no two
    profiles share the card. A profile that comes back empty is taken
    again in a new process; after ``tries`` empty ones the time is not
    measured (None). A child that fails raises."""
    out = [None] * len(jobs)
    pending = list(range(len(jobs)))
    if not jobs:
        return out
    with tempfile.NamedTemporaryFile(suffix=".lock") as lock:
        env = dict(os.environ, **{GPU_LOCK_ENV: lock.name})
        for attempt in range(1, tries + 1):
            t0 = time.perf_counter()
            procs = [(i, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--breakdown",
                 jobs[i][0]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env)) for i in pending]
            empty = []
            try:
                for i, proc in procs:
                    stdout, stderr = proc.communicate(timeout=600)
                    tag, lines = jobs[i][1], stdout.strip().splitlines()
                    if proc.returncode != 0 or not lines:
                        raise RuntimeError(
                            f"breakdown {tag}: child failed "
                            f"({proc.returncode}):\n{stdout}\n"
                            f"{stderr[-3000:]}")
                    parts = json.loads(lines[-1])
                    if not parts:
                        log(f"breakdown {tag}: process {attempt} recorded "
                            "no device kernel")
                        empty.append(i)
                        continue
                    out[i] = parts
                    log(f"breakdown {tag}: device "
                        f"{sum(parts.values()):.4f} ms: " + ", ".join(
                            f"{k} {v:.4f} ms" for k, v in sorted(
                                parts.items(), key=lambda kv: -kv[1]))
                        + (f" (process {attempt})" if attempt > 1 else ""))
            finally:
                # a failure or a timeout leaves no child on the card
                for _, proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.communicate()
            log(f"breakdowns: {len(procs)} processes in "
                f"{time.perf_counter() - t0:.1f} s")
            pending = empty
            if not pending:
                break
    for i in pending:
        log(f"breakdown {jobs[i][1]}: device time not measured")
    return out


def breakdown_in_child(name, tag):
    return breakdowns_in_children([(name, tag)])[0]


def ms_or_none(fmt, x):
    """``x`` formatted, or "not measured" when it is None."""
    return "not measured" if x is None else format(x, fmt)


def phase_probes(results):
    """Phase 17: K10 and K11 vs their plain versions at the scripts' full
    shape, K11 vs K2, one launch per call; times beside K2, the bounds and
    the plain versions; then both twins' mains at their defaults, the
    counters read around them. Fills ``results``; returns the mains'
    launch counts."""
    L, D = PROBE_SHAPE
    for (kind, R), dtype in itertools.product(
            PROBE_CASES, (torch.float32, torch.bfloat16)):
        a = scan_inputs(R, L, D, dtype, seed=L + D + 17 + R)
        tag = f"{PROBE_NAMES[kind]} {kind} R={R} {str(dtype)[6:]}"
        counter = "scan_flat" if kind == "flat" else "scan_lb"
        before = probe_counts()[counter]
        out_k = probe_call(kind, a)
        torch.cuda.synchronize()
        if probe_counts()[counter] != before + 1:
            raise AssertionError(f"{tag}: {probe_counts()[counter] - before}"
                                 " launches for one call")
        width, per = probe_width(kind, R, L, D)
        err = check_close(tag, out_k, probe_plain(kind, a, width),
                          *TOL[dtype])
        row = dict(kind=kind, R=R, dtype=str(dtype)[6:], max_abs_err=err,
                   width=width)
        k2 = lambda: scan_fused.mamba_scan_fused(
            a["u"], a["dt"], a["z"], a["A"], a["B"], a["C"], a["D"],
            a["bias"])
        if kind == "flat":   # K2's function: against K2's kernel too
            row["err_vs_k2"] = check_close(f"{tag} vs K2", out_k, k2(),
                                           *TOL[dtype])
        del out_k
        if dtype == torch.bfloat16:
            kern = lambda: probe_call(kind, a)
            row["ms"] = cuda_ms(kern, 5)
            row["k2_ms"] = cuda_ms(k2, 5)
            row["plain_ms"] = cuda_ms(lambda: probe_plain(kind, a, width), 1,
                                      warmup=0)   # warmed by the check
            row["bound_ms"], row["bound_by"] = probe_bound(kind, R, L, D,
                                                           dtype)
            log(f"kernel {tag}: max_abs_err {err:.3e}"
                + (f" (vs K2 {row['err_vs_k2']:.3e})" if kind == "flat"
                   else "")
                + f", kernel {row['ms']:.4f} ms, K2 {row['k2_ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms (slices of {width} of {D}, "
                f"{per:.1f} B per row, step and channel at 4096 steps), "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        else:
            log(f"kernel {tag}: max_abs_err {err:.3e}"
                + (f" (vs K2 {row['err_vs_k2']:.3e})" if kind == "flat"
                   else ""))
        results.append(row)
        del a
        torch.cuda.empty_cache()
    names = ("k2", "noshift", "nohs", "flat")
    device = {name: None if parts is None else sum(parts.values())
              for name, parts in zip(names, breakdowns_in_children(
                  [(n, f"{n} stage 0 R=1 bf16") for n in names]))}
    by = {(r["kind"], r["R"]): r for r in results if r["dtype"] == "bfloat16"}
    for kind in ("noshift", "nohs", "flat"):
        by[kind, 1]["device_ms"] = device[kind]
        by[kind, 1]["k2_device_ms"] = device["k2"]
    nohs, noshift = by[("nohs", 1)], by[("noshift", 1)]
    gap = (None if None in (device["k2"], device["nohs"])
           else device["k2"] - device["nohs"])
    log(f"K2 - K10(nohs), R=1 bf16: {nohs['k2_ms'] - nohs['ms']:.4f} ms by "
        f"events ({nohs['k2_ms']:.4f} - {nohs['ms']:.4f}), "
        f"{ms_or_none('.4f', gap)} ms device "
        f"({ms_or_none('.4f', device['k2'])} - "
        f"{ms_or_none('.4f', device['nohs'])}); K10 "
        f"noshift - nohs {noshift['ms'] - nohs['ms']:.4f} ms; K11 / K2 "
        + ", ".join(f"R={R} {by['flat', R]['ms'] / by['flat', R]['k2_ms']:.3f}"
                    for R in PROBE_FLAT_ROWS))

    # the main path: the twins' mains at their defaults
    reset_counts()
    bench_scan_lb.main([])
    bench_scan_flat.main([])
    counts = launch_counts()
    per_time = 1 + 3 * 6          # chain_time: a warm-up, 3 reps of k = 6
    flat = len(PROBE_FLAT_ROWS) * (1 + per_time)
    want = expected_counts(scan_fused=per_time + flat,
                           scan_lb=2 * per_time, scan_flat=flat)
    variants = dict(bench_scan_lb.VARIANT_LAUNCHES)
    if counts != want or variants != dict.fromkeys(variants, per_time):
        raise AssertionError(f"twins' mains: launches {counts}, K10 by "
                             f"variant {variants}")
    log(f"twins' mains: launches {counts}; K10 by variant {variants}")
    return dict(counts=counts, variants=variants)


def phantom_volume(frame=BRATS_FRAME, seed=0):
    """(1, 4, *frame) float32 brain phantom on the card, each channel
    z-scored over the brain, zero outside it."""
    images, _ = phantom_case(frame, seed)
    x = images.astype(np.float32)
    brain = images[0] != 0
    for c in range(x.shape[0]):
        v = x[c][brain]
        x[c][brain] = (v - v.mean()) / v.std()
    return torch.from_numpy(x)[None].cuda()


def wv_check(tag, out, frame, box, counts, per_call):
    """Exact K1/K2 launches, finite float32 logits of the frame's shape,
    class 0 at 20.0 (the others 0) outside ``box``."""
    want = expected_counts(**per_call)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")
    if (tuple(out.shape) != (1, 4, *frame) or out.dtype != torch.float32
            or not torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: logits {tuple(out.shape)} "
                             f"{out.dtype} or non-finite values")
    if box is None:
        return
    outside = torch.ones(frame, dtype=torch.bool, device=out.device)
    outside[tuple(slice(lo, hi) for lo, hi in box)] = False
    if not (bool((out[0, 0][outside] == 20.0).all())
            and bool((out[0, 1:][:, outside] == 0).all())):
        raise AssertionError(f"{tag}: background outside the box is not "
                             "class 0 at 20.0")


def phase_whole_volume(results):
    """Whole-volume inference: K1/K2 at its shapes, the f32 forward on
    the phantom vs plain scans, bf16 times, checks; returns the stats."""
    phase_kernels(results, WV_SHAPES)
    phantom = phantom_volume()
    box = nonzero_bbox(phantom)
    crop = tuple(hi - lo for lo, hi in box)
    stats = dict(phantom_box=box)
    model = SegMamba(in_chans=4, out_chans=4,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda").eval()
    with torch.inference_mode():
        reset_counts()
        y_k = whole_volume_inference(model, phantom)
        torch.cuda.synchronize()
        wv_check("f32 phantom", y_k, BRATS_FRAME, box, launch_counts(),
                 WV_PER_FORWARD)
        torch.cuda.reset_peak_memory_stats()
        with plain_scans():
            y_p = whole_volume_inference(model, phantom)
        torch.cuda.synchronize()
        plain_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        # the scale of the computed logits, not of the pinned background
        scale = float(y_p[(slice(None), slice(None)) + tuple(
            slice(lo, hi) for lo, hi in box)].abs().max())
        err = check_close("f32 whole volume (kernel vs plain scans)", y_k,
                          y_p, 2e-3, 1e-2 * scale)
    log(f"f32 whole volume, phantom {BRATS_FRAME} box {box} (crop {crop}):"
        f" max|ref| {scale:.4f}, max abs err {err:.3e}; plain side peak "
        f"{plain_gib:.2f} GiB")
    stats["f32_max_abs_err"], stats["f32_scale"] = err, scale
    del model, y_k, y_p
    gc.collect()
    torch.cuda.empty_cache()

    model = SegMamba(in_chans=4, out_chans=4, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda").eval()
    bench = np.moveaxis(np.random.default_rng(0).standard_normal(
        (1, *CASE_SHAPE, 4)), -1, 1)
    bench = torch.from_numpy(bench.astype(np.float32)).cuda()
    tta_calls = {k: 8 * v for k, v in WV_PER_FORWARD.items()}
    runs = {
        "wholevol_bench": (lambda: whole_volume_inference(model, bench),
                           CASE_SHAPE, None, WV_PER_FORWARD),
        "wholevol_phantom": (lambda: whole_volume_inference(model, phantom),
                             BRATS_FRAME, box, WV_PER_FORWARD),
        "wholevol_uncropped": (lambda: whole_volume_inference(
            model, phantom, crop_to_nonzero=False), BRATS_FRAME, None,
            WV_PER_FORWARD),
        "wholevol_tta_bench": (lambda: whole_volume_tta(
            model, bench, (0, 1, 2)), CASE_SHAPE, None, tta_calls),
    }
    with torch.inference_mode():
        for name, (fn, frame, rbox, per_call) in runs.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out = fn()
            torch.cuda.synchronize()
            counts = launch_counts()
            wv_check(name, out, frame, rbox, counts, per_call)
            del out
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            stats[name] = dict(
                sec=statistics.median(times), times=times, peak_gib=peak,
                launches={k: counts[k] for k in per_call})
            log(f"{name}: {stats[name]['sec']:.4f} s/case (median of 3: "
                f"{', '.join(f'{t:.4f}' for t in times)}), peak "
                f"{peak:.2f} GiB, launches {stats[name]['launches']}")
    stats["deploy"] = phase_deploy(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_deploy(model):
    """One raw phantom case through ``SegmentationAlgorithm`` (weights from
    a checkpoint of ``model``; sliding window, roi 128^3, overlap 0.5,
    sw_batch 1, mirror TTA over 3 axes, bf16) -> NIfTI, then
    ``compute_metrics`` on it against the case's seg."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        raw = os.path.join(tmp, "raw")
        images, _ = write_raw_phantom_case(os.path.join(raw, "phantom_0"),
                                           BRATS_FRAME, seed=1)
        ckpt = os.path.join(tmp, "model.pt")
        torch.save({"model": model.state_dict()}, ckpt)
        write_s = time.perf_counter() - t0
        algo = SegmentationAlgorithm(
            SegMamba(in_chans=4, out_chans=4, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(1)), ckpt,
            input_dir=raw, output_dir=os.path.join(tmp, "pred", "deploy"),
            data_filenames=MODALITIES, roi_size=ROI, sw_batch_size=1,
            overlap=0.5, mirror_axes=(0, 1, 2), device="cuda")
        for k, v in model.state_dict().items():
            if not torch.equal(algo.model.state_dict()[k], v):
                raise AssertionError(f"deploy: weight {k} not loaded")
        crop = [hi - lo for lo, hi in bbox_from_mask(
            create_nonzero_mask(images))]
        padded = [-(-max(c, r) // 32) * 32 for c, r in zip(crop, ROI)]
        n_windows = len(_scan_starts(padded, ROI, 0.5))
        reset_counts()
        (path,) = algo.process()
        counts = launch_counts()
        want = expected_counts(scan_dir=n_windows * 8 * 16,
                               scan_fused=n_windows * 8 * 8)
        if counts != want:
            raise AssertionError(f"deploy: launches {counts}, expected "
                                 f"{want} ({n_windows} windows x 8 flips)")
        pred = read_nifti(path)
        labels = set(np.unique(pred).tolist())
        if pred.shape != BRATS_FRAME or not labels <= {0, 1, 2, 3}:
            raise AssertionError(f"deploy: prediction {pred.shape}, labels "
                                 f"{sorted(labels)}")
        t1 = time.perf_counter()
        arr = compute_metrics.main([
            "--pred_name", "deploy", "--pred-dir", os.path.join(tmp, "pred"),
            "--gt-dir", raw, "--raw-gt", "--out", os.path.join(tmp, "m")])
        metrics_s = time.perf_counter() - t1
    if arr is None or arr.shape != (1, 3, 2) or not np.isfinite(arr).all():
        raise AssertionError(f"deploy: metrics {arr}")
    split = dict(algo.timings["phantom_0"], write_case_s=write_s,
                 metrics_s=metrics_s)
    log(f"deploy case {BRATS_FRAME} (crop {crop}, {n_windows} windows x 8 "
        f"flips): labels {sorted(labels)}, dice {arr[0, :, 0].tolist()}, "
        f"hd95 {arr[0, :, 1].tolist()}; seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()))
    return dict(split, n_windows=n_windows, crop=crop,
                launches={k: counts[k] for k in WV_PER_FORWARD},
                metrics=arr[0].tolist())


# ---------------------------------------------------------------------------
# phase 19: parallelism (data, sequence and tensor) through the launcher

PAR_SHAPES = {   # K6 at the sequence-parallel shard shapes (2 ranks, R=2)
    "sp_stage0": (2, 131072, 96), "sp_stage1": (2, 16384, 192),
    "sp_stage2": (2, 2048, 384), "sp_stage3": (2, 256, 768)}
PAR_STEPS = {    # name: (mesh axes, shape, model axis, scan launches a step)
    "sp": (("data", "seq"), (1, 2), None,
           dict(scan_core=24, scan_core_bwd=24)),
    "dp": (("data",), (2,), None, dict(scan_dir=16, scan_fused=8,
                                       scan_dir_bwd=16, scan_fused_bwd=8)),
    "tp": (("model",), (2,), "model", dict(scan_dir=16, scan_fused=8,
                                           scan_dir_bwd=16,
                                           scan_fused_bwd=8)),
}
PAR_LAYER = (2, 262144, 48, 64)   # (c): batch, L, d_model, nslices (f32)
PAR_BF16_TIER = (3e-2, 5e-2)      # rtol; atol x a parameter's max |grad|
PAR_F32_ROI = (64, 64, 64)        # (b)'s float32 steps: 2 x 4 x 64^3
PAR_F32_TIER = (2e-3, 1e-2)       # rtol; atol x a parameter's max |grad|
PAR_F32_REL = 1e-3                # their gradients' relative L2, at most
PAR_SPLIT_REL = 1e-4              # the DP step's from the split plain step
PAR_TIMED_STEPS = 1
# conv biases that feed an instance norm: their gradient is rounding noise
IN_FED_BIASES = tuple(f"vit.gscs.{i}.{name}.bias" for i in range(4)
                      for name in ("proj", "proj2", "proj3", "proj4"))


def par_batch(device, roi=None, seed=0):
    """Phase 7's batch (2 x 4 x 128^3 from default_rng(0)); (b)'s float32
    steps take 2 x 4 x 64^3 from default_rng(1)."""
    roi = ROI if roi is None else roi
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal(
                (2, 4, *roi)).astype(np.float32)).to(device),
            "label": torch.from_numpy(rng.integers(0, 4, (2, *roi))).to(
                device)}


def par_model(device, mesh=None, model_axis=None, scan_impl="dir2",
              dtype=torch.bfloat16):
    """Phase 7's model: full BraTS width, bf16, remat convs, seed 0."""
    return SegMamba(in_chans=4, out_chans=4, dtype=dtype,
                    remat="convs", scan_impl=scan_impl,
                    generator=torch.Generator().manual_seed(0),
                    device=device, mesh=mesh, seq_axis="seq",
                    model_axis=model_axis)


def par_step(state, batch, mesh=None):
    """One counted step (cudnn deterministic): (metrics as floats, the
    gradients it applied)."""
    with torch.backends.cudnn.flags(deterministic=True):
        m = train_step(state, batch, mesh=mesh)
    grads = {n: p.grad.detach() for n, p in state.model.named_parameters()}
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}, \
        grads


def par_layer(device, mesh=None):
    """(c)'s float32 stage-0 MambaV3, seed 0, and its input and
    cotangent."""
    b, L, d, S = PAR_LAYER
    layer = MambaV3(d, nslices=S, generator=torch.Generator().manual_seed(0),
                    device=device, mesh=mesh, seq_axis="seq")
    g = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(b, L, d, generator=g, device=device)
    cot = torch.randn(b, L, d, generator=g, device=device)
    return layer, x.requires_grad_(), cot


def par_layer_run(layer, x, cot):
    y = layer(x)
    (y.float() * cot).sum().backward()
    return {"y": y.detach(), "x": x.grad.detach(),
            **{n: p.grad.detach() for n, p in layer.named_parameters()}}


def par_distance(grads, want):
    """Relative L2 of ``grads`` from ``want`` over every parameter, and the
    largest elementwise difference."""
    num = den = top = 0.0
    for k, w in want.items():
        d = grads[k].float().cpu().double() - w.double()
        num += float(d.square().sum())
        den += float(w.double().square().sum())
        top = max(top, float(d.abs().max()))
    return (num / den) ** 0.5, top


def par_split_step(device, batch, dtype):
    """The plain step on each sample of ``batch`` alone from seed 0, the
    losses and the gradients averaged in float32 (the DP step's arithmetic
    without its collective)."""
    parts, losses = [], []
    for i in range(2):
        model = par_model(device, dtype=dtype)
        state = create_train_state(model, learning_rate=1e-2)
        metrics, grads = par_step(state, {k: v[i:i + 1]
                                          for k, v in batch.items()})
        parts.append({k: v.float().cpu() for k, v in grads.items()})
        losses.append(metrics["loss"])
        del model, state, grads
    grads = {k: (parts[0][k] + parts[1][k]) / 2 for k in parts[0]}
    norm = float(torch.linalg.vector_norm(torch.cat(
        [g.reshape(-1) for g in grads.values()])))
    return {"loss": sum(losses) / 2, "grad_norm": norm, "grads": grads}


def par_references(path, device="cuda"):
    """The single-process references, in this process, saved to ``path``:
    the plain step (twice: its own run-to-run spread), the mxu composition's
    step (two compositions of one computation: the rounding a bf16 step
    carries), the split step (the plain step on each sample alone, the
    gradients averaged in float32: the DP step's arithmetic without its
    collective), the float32 plain step on (b)'s 64^3 batch, and (c)'s
    unsharded layer."""
    batch = par_batch(device)
    ref = {}
    for run in ("plain", "plain_again", "mxu"):
        model = par_model(device, scan_impl="mxu" if run == "mxu" else "dir2")
        state = create_train_state(model, learning_rate=1e-2)
        metrics, grads = par_step(state, batch)
        ref[run] = dict(metrics, grads={k: v.cpu() for k, v in grads.items()})
        if run != "mxu":
            ref[run]["params"] = {k: v.detach().cpu() for k, v in
                                  model.state_dict().items()}
        del model, state, grads
        torch.cuda.empty_cache()
    f32_batch = par_batch(device, PAR_F32_ROI, seed=1)
    ref["split"] = par_split_step(device, batch, torch.bfloat16)
    ref["f32_split"] = par_split_step(device, f32_batch, torch.float32)
    model = par_model(device, dtype=torch.float32)
    state = create_train_state(model, learning_rate=1e-2)
    metrics, grads = par_step(state, f32_batch)
    ref["f32"] = dict(metrics, grads={k: v.cpu() for k, v in grads.items()})
    del model, state, grads, f32_batch
    torch.cuda.empty_cache()
    layer, x, cot = par_layer(device)
    reset_counts()
    ref["layer"] = {k: v.cpu() for k, v in par_layer_run(layer, x,
                                                          cot).items()}
    del layer, x, cot
    torch.save(ref, path)
    for run in ("plain", "plain_again", "mxu"):
        log(f"parallel reference {run}: loss {ref[run]['loss']:.6f}, grad "
            f"norm {ref[run]['grad_norm']:.6f}")
    spread = {k: float((ref["plain_again"]["grads"][k] - g).abs().max())
              for k, g in ref["plain"]["grads"].items()}
    log(f"parallel reference: plain step twice, gradients differ by at most "
        f"{max(spread.values()):.3e} (cudnn deterministic)")
    for run, plain in (("mxu", "plain"), ("split", "plain"),
                       ("f32_split", "f32")):
        rel, top = par_distance(ref[run]["grads"], ref[plain]["grads"])
        log(f"parallel reference: {run} step vs the {plain} step: gradients' "
            f"relative L2 {rel:.3e}, max |diff| {top:.3e}")
    log(f"parallel reference f32 (2 x 4 x 64^3): loss "
        f"{ref['f32']['loss']:.6f}, grad norm {ref['f32']['grad_norm']:.6f}")
    del ref, batch
    gc.collect()
    torch.cuda.empty_cache()


def par_hold(tag, metrics, grads, ref):
    """A step against the single-process step: loss and gradient norm at
    the bf16 tier's rtol; each parameter's gradient within the larger of
    the bf16 tier elementwise (rtol 3e-2, atol 5e-2 x the larger of its
    max |grad| and 1e-3 of the model's, phase 6's floor; the
    instance-norm-fed biases' atol by the model's) and twice the mxu
    composition's distance from the plain step on it; all together within the larger of 3e-2 and twice
    that composition's relative L2. Returns the worst share of the tier
    (above 1 where a parameter passed by the mxu bound)."""
    rtol, atol = PAR_BF16_TIER
    plain, mxu = ref["plain"], ref["mxu"]
    for key in ("loss", "grad_norm"):
        want = plain[key]
        if not abs(metrics[key] - want) <= rtol * abs(want):
            raise AssertionError(f"{tag}: {key} {metrics[key]} vs the "
                                 f"single-process step's {want}")
    top = max(float(w.abs().max()) for w in plain["grads"].values())
    worst, num, den, cal_num = 0.0, 0.0, 0.0, 0.0
    for k, w in plain["grads"].items():
        g = grads[k].float().cpu()
        err = (g - w).abs()
        cal = float((mxu["grads"][k] - w).abs().max())
        scale = top if k in IN_FED_BIASES else max(float(w.abs().max()),
                                                   1e-3 * top)
        share = float((err / (atol * scale + rtol * w.abs()).clamp_min(
            1e-30)).max())
        if not (share <= 1.0 or float(err.max()) <= 2 * cal):
            raise AssertionError(
                f"{tag}: gradient {k} max |err| {float(err.max()):.4e}, "
                f"{share:.2f}x the bf16 tier (mxu vs plain {cal:.4e})")
        worst = max(worst, share)
        num += float((g - w).double().square().sum())
        cal_num += float((mxu["grads"][k] - w).double().square().sum())
        den += float(w.double().square().sum())
    rel, cal_rel = (num / den) ** 0.5, (cal_num / den) ** 0.5
    if tag.startswith("dp"):
        # DP's distance is the batch split's rounding: the plain step on
        # each sample alone, averaged, is DP without its collective
        split_rel, split_top = par_distance(grads, ref["split"]["grads"])
        log(f"  {tag}: vs the split plain step: relative L2 {split_rel:.3e}, "
            f"max |diff| {split_top:.3e}")
        if not split_rel <= PAR_SPLIT_REL:
            raise AssertionError(f"{tag}: {split_rel:.3e} from the split "
                                 "plain step")
    if not rel <= max(3e-2, 2 * cal_rel):
        raise AssertionError(f"{tag}: gradients' relative L2 {rel:.3e} "
                             f"(mxu vs plain {cal_rel:.3e})")
    log(f"  {tag}: loss {metrics['loss']:.6f} (single {plain['loss']:.6f}), "
        f"grad norm {metrics['grad_norm']:.6f} ({plain['grad_norm']:.6f}); "
        f"gradients' relative L2 {rel:.3e} (mxu vs plain {cal_rel:.3e}), "
        f"worst share of the bf16 tier by a parameter {worst:.3f} (over 1: "
        "within twice the mxu composition's distance)")
    return worst


def par_hold_f32(tag, metrics, grads, want):
    """A float32 step against its float32 single-process reference
    ``want`` (the plain step; for DP the split step, since splitting the
    batch reorders the convs' weight-gradient sums), where rounding is
    small and a gradient's wrong scope (a missing or doubled sum over
    ranks) is not: loss and gradient norm at rtol 2e-3, every parameter's
    gradient at rtol 2e-3 / atol 1e-2 x the larger of its max |grad| and
    1e-3 of the model's (the instance-norm-fed biases' atol by the
    model's), all together within ``PAR_F32_REL`` relative L2. Returns
    (relative L2, worst share of the tier)."""
    rtol, atol = PAR_F32_TIER
    for key in ("loss", "grad_norm"):
        if not abs(metrics[key] - want[key]) <= rtol * abs(want[key]):
            raise AssertionError(f"{tag}: {key} {metrics[key]} vs the "
                                 f"float32 reference's {want[key]}")
    top = max(float(w.abs().max()) for w in want["grads"].values())
    worst = 0.0
    for k, w in want["grads"].items():
        err = (grads[k].float().cpu() - w).abs()
        scale = top if k in IN_FED_BIASES else max(float(w.abs().max()),
                                                   1e-3 * top)
        share = float((err / (atol * scale + rtol * w.abs()).clamp_min(
            1e-30)).max())
        if not share <= 1.0:
            raise AssertionError(f"{tag}: gradient {k} max |err| "
                                 f"{float(err.max()):.4e}, {share:.2f}x the "
                                 "f32 tier")
        worst = max(worst, share)
    rel, _ = par_distance(grads, want["grads"])
    if not rel <= PAR_F32_REL:
        raise AssertionError(f"{tag}: gradients' relative L2 {rel:.3e} from "
                             "the float32 reference")
    log(f"  {tag}: loss {metrics['loss']:.6f} ({want['loss']:.6f}), grad "
        f"norm {metrics['grad_norm']:.6f} ({want['grad_norm']:.6f}); "
        f"gradients' relative L2 {rel:.3e}, worst share of the f32 tier "
        f"{worst:.3f}")
    return rel, worst


@contextlib.contextmanager
def par_comm_timer(stats):
    """Add the calls, bytes (of this rank's input) and host seconds of
    every ``all_gather`` / ``all_reduce`` inside the block to ``stats``
    (gloo on CUDA tensors returns when the collective is done)."""
    dist = torch.distributed
    saved = dist.all_gather, dist.all_reduce

    def timed(fn, arg):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            stats["sec"] += time.perf_counter() - t0
            stats["calls"] += 1
            stats["bytes"] += args[arg].numel() * args[arg].element_size()
            return out
        return call

    dist.all_gather, dist.all_reduce = timed(saved[0], 1), timed(saved[1], 0)
    try:
        yield stats
    finally:
        dist.all_gather, dist.all_reduce = saved


def par_identical(tensors, group=None):
    """Whether every rank holds bit-equal ``tensors``."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    parts = [torch.empty_like(flat)
             for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, flat, group=group)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def par_rank_nccl(rank, world_size, device, path):
    """(a): a world of 1 over NCCL: ``train_step(mesh=)`` on phase 7's
    batch equals the single-process step up to that step's own
    run-to-run spread (0 when it is deterministic)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(path, weights_only=True)
    plain, again = ref["plain"], ref["plain_again"]
    mesh = make_mesh(1, ("data",), device=device)
    model = par_model(device, mesh)
    state = create_train_state(model, learning_rate=1e-2, mesh=mesh)
    reset_counts()
    with torch.backends.cudnn.flags(deterministic=True):
        metrics, grads = par_step(state, par_batch(device), mesh)
    counts = {k: v for k, v in launch_counts().items() if v}
    if counts != PAR_STEPS["dp"][3]:
        raise AssertionError(f"(a) scan launches {counts}")
    worst = 0.0
    for kind, got, key in (("gradient", grads, "grads"),
                           ("parameter", model.state_dict(), "params")):
        for k, w in plain[key].items():
            err = float((got[k].cpu() - w).abs().max())
            spread = float((again[key][k] - w).abs().max())
            if not err <= spread:
                raise AssertionError(f"(a) {kind} {k}: {err:.3e} from the "
                                     f"single-process step (its own spread "
                                     f"{spread:.3e})")
            worst = max(worst, err)
    for key in ("loss", "grad_norm"):
        if metrics[key] != plain[key] and plain[key] == again[key]:
            raise AssertionError(f"(a) {key} {metrics[key]} != "
                                 f"{plain[key]}")
    return dict(metrics, worst_abs=worst, counts=counts,
                backend=torch.distributed.get_backend())


def par_rank_shared(rank, world_size, device, path):
    """(b) and (c): two ranks over gloo on one shared card. For each of
    the SP, DP and TP steps: one counted step from seed 0 held against the
    single-process step (rank 0), then ``PAR_TIMED_STEPS`` timed steps
    (host clock after synchronize; the collectives' host seconds, calls
    and bytes), then the parameters bit-equal on both ranks; the SP model
    also runs one counted forward (an SP window). Then (c)'s
    float32 stage-0 layer under SP 2 against the unsharded layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(path, weights_only=True) if rank == 0 else None
    global_batch = par_batch("cpu")
    out = {}
    for name, (axes, shape, model_axis, per_step) in PAR_STEPS.items():
        mesh = make_mesh(world_size, axes, shape=shape, device=device)
        model = par_model(device, mesh, model_axis)
        state = create_train_state(model, learning_rate=1e-2, mesh=mesh,
                                   model_axis=model_axis)
        batch = shard_batch(global_batch, mesh)
        reset_counts()
        metrics, grads = par_step(state, batch, mesh)
        counts = {k: v for k, v in launch_counts().items() if v}
        if counts != per_step:
            raise AssertionError(f"{name}: scan launches {counts}, "
                                 f"expected {per_step}")
        if state.sharded:
            grads = tp_gather_state(grads, mesh, state.sharded)
        row = dict(metrics, counts=counts)
        if rank == 0:
            row["worst"] = par_hold(f"{name} step (rank 0)", metrics, grads,
                                    ref)
        del grads
        # the peak of a training step (the checked one ran cudnn's
        # deterministic algorithms, whose workspaces differ)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, comm_stats = [], dict(calls=0, bytes=0, sec=0.0)
        for _ in range(PAR_TIMED_STEPS):
            torch.cuda.synchronize()
            torch.distributed.barrier()   # rank 0 held the step just now
            t0 = time.perf_counter()
            with par_comm_timer(comm_stats):
                train_step(state, batch, mesh=mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        # a tensor-parallel shard is this rank's own; the rest is shared
        params = [p for n, p in model.named_parameters()
                  if n not in state.sharded]
        if not par_identical(params):
            raise AssertionError(f"{name}: parameters differ across ranks "
                                 "after the steps")
        row.update(sec=statistics.median(times), times=times,
                   comm={k: v / PAR_TIMED_STEPS
                         for k, v in comm_stats.items()},
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if name == "sp":
            reset_counts()
            with torch.no_grad():
                model(batch["image"][:1])
            row["window_counts"] = {k: v for k, v in
                                    launch_counts().items() if v}
            if row["window_counts"] != dict(scan_core=24):
                raise AssertionError(f"SP window launches "
                                     f"{row['window_counts']}")
        out[name] = row
        del model, state, batch, params
        gc.collect()
        torch.cuda.empty_cache()
    # the same steps in float32 on a 64^3 batch against the float32 plain
    # step: what rounding leaves of the bf16 distances
    f32_batch = par_batch("cpu", PAR_F32_ROI, seed=1)
    for name, (axes, shape, model_axis, per_step) in PAR_STEPS.items():
        mesh = make_mesh(world_size, axes, shape=shape, device=device)
        model = par_model(device, mesh, model_axis, dtype=torch.float32)
        state = create_train_state(model, learning_rate=1e-2, mesh=mesh,
                                   model_axis=model_axis)
        reset_counts()
        metrics, grads = par_step(state, shard_batch(f32_batch, mesh), mesh)
        counts = {k: v for k, v in launch_counts().items() if v}
        if counts != per_step:
            raise AssertionError(f"{name} f32: scan launches {counts}, "
                                 f"expected {per_step}")
        if state.sharded:
            grads = tp_gather_state(grads, mesh, state.sharded)
        if rank == 0:
            want = ref["f32_split" if name == "dp" else "f32"]
            out[name]["f32_rel"], out[name]["f32_worst"] = par_hold_f32(
                f"{name} f32 step (rank 0)", metrics, grads, want)
            out[name]["f32_plain_rel"] = par_distance(
                grads, ref["f32"]["grads"])[0]
        del model, state, grads
        gc.collect()
        torch.cuda.empty_cache()
    # (c): float32 stage-0 layer under SP 2 against the unsharded layer
    mesh = make_mesh(world_size, ("seq",), device=device)
    layer, x, cot = par_layer(device, mesh)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    got = par_layer_run(layer, x, cot)
    counts = {k: v for k, v in launch_counts().items() if v}
    if counts != dict(scan_core=3, scan_core_bwd=3):
        raise AssertionError(f"(c) scan launches {counts}")
    row = dict(counts=counts,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if rank == 0:
        rtol, atol = TOL[torch.float32]
        errs = {}
        for k, w in ref["layer"].items():
            a = atol if k in ("y", "x") else atol * max(
                1.0, float(w.abs().max()))
            errs[k] = (check_close(f"(c) {k}", got[k].cpu(), w, rtol, a),
                       float(w.abs().max()))
        row["max_abs_err"] = max(e for e, _ in errs.values())
        row["errs"] = errs
    out["layer"] = row
    return out


def par_ddelta(name, got, plain32, operands):
    """K6's ddelta at an SP shard shape: at the f32 tier against the plain
    float32 version, or, on the channels where the two differ by more,
    against a float64 run of the plain version there: within the tier, or
    within ``DDELTA_PLAIN_MULT`` times the plain float32 version's share
    of it (phase 14's rule). ddelta = sum_n A g x
    a + u sum_n g B sums each state's adjoint over the steps after it, and
    on long sequences a few values cancel terms far larger than
    themselves (ROADMAP C5). Returns the max abs error against the plain
    float32 version."""
    rtol, atol = TOL[torch.float32]
    diff = (got.float() - plain32.float()).abs()
    bad = diff > atol + rtol * plain32.float().abs()
    if not bad.any():
        return float(diff.max())
    ch = bad.any(0).any(0).nonzero()[:, 0]
    u, delta, A, B, C, dy, dlast = operands
    leaves = [t.double().requires_grad_()
              for t in (u[..., ch], delta[..., ch], A[ch], B, C)]
    y, last = scan_core.selective_scan_core_ref(
        *leaves, chunk_size=scan_core.DEF_CHUNK)
    want64 = torch.autograd.grad((y, last), leaves, (
        dy[..., ch].double(), dlast[:, ch].double()))[1]
    share = tier_use(got[..., ch], want64, rtol, atol)
    plain_share = tier_use(plain32[..., ch], want64, rtol, atol)
    limit = max(1.0, DDELTA_PLAIN_MULT * plain_share)
    log(f"K6 {name} ddelta: {int(bad.sum())} of {bad.numel()} values over "
        f"the f32 tier against the plain float32 version (max abs err "
        f"{float(diff.max()):.3e}), on {len(ch)} channel(s); there against "
        f"float64 the kernel uses {share:.3f} of the tier, the plain float32 "
        f"version {plain_share:.3f} (held to {limit:.3f})")
    if not share <= limit:
        raise AssertionError(f"K6 {name} ddelta: {share:.3f} of the f32 tier "
                             f"against float64, over {limit:.3f}")
    return float(diff.max())


def par_kernels(rows):
    """K6 forward and backward at the SP shard shapes (float32): CUDA
    events, bounds; at stage 0 also against the plain version (one run
    each) and the fix-up's forward + backward."""
    T = scan_core.DEF_CHUNK
    rtol, atol = TOL[torch.float32]
    fix_ms = 0.0
    for name, (R, L, D) in PAR_SHAPES.items():
        u, delta, A, B, C = core_inputs(R, L, D, seed=L + D + 3)
        g = torch.Generator(device=DEVICE).manual_seed(L)
        dy = torch.randn(R, L, D, generator=g, device=DEVICE)
        dlast = torch.randn(R, D, N, generator=g, device=DEVICE)
        y, st = scan_core._launch(u, delta, A, B, C, T)
        row = dict(shape=name, R=R, L=L, D=D)
        row["fwd_ms"] = cuda_ms(lambda: scan_core._launch(u, delta, A, B, C,
                                                          T), 10)
        row["bwd_ms"] = cuda_ms(lambda: scan_core._launch_bwd(
            u, delta, A, B, C, dy, dlast, st, T), 10)
        row["fwd_bound_ms"], row["fwd_bound_by"] = core_bound("fwd", R, L, D)
        row["bwd_bound_ms"], row["bwd_bound_by"] = core_bound("bwd", R, L, D)
        if name == "sp_stage0":
            y_p, st_p = scan_core.selective_scan_core_ref(
                u, delta, A, B, C, T, return_states=True)
            err = max(check_close(f"K6 {name} y", y, y_p, rtol, atol),
                      check_close(f"K6 {name} states", st, st_p, rtol, atol))
            row["fwd_plain_ms"] = cuda_ms(
                lambda: scan_core.selective_scan_core_ref(
                    u, delta, A, B, C, T, return_states=True), 1, warmup=0)
            got = scan_core._launch_bwd(u, delta, A, B, C, dy, dlast, st, T)
            want = scan_core.selective_scan_core_bwd_ref(u, delta, A, B, C,
                                                         dy, dlast, T)
            for gname, gk, w in zip(CORE_GRADS, got, want):
                a = atol * max(1.0, float(w.abs().max())) \
                    if gname in ("dA", "dB", "dC") else atol
                if gname == "ddelta":
                    err = max(err, par_ddelta(name, gk, w, (u, delta, A, B,
                                                           C, dy, dlast)))
                    continue
                err = max(err, check_close(f"K6 {name} {gname}", gk, w,
                                           rtol, a))
            row["max_abs_err"] = err
            del got, want, y_p, st_p
            row["bwd_plain_ms"] = cuda_ms(
                lambda: scan_core.selective_scan_core_bwd_ref(
                    u, delta, A, B, C, dy, dlast, T), 1, warmup=0)
        # the fix-up at this shard's shape, forward + backward
        fix_in = [C.clone(), torch.cumsum(delta, 1), A.clone(),
                  torch.randn(R, D, N, generator=g, device=DEVICE)]
        fix_in = [t.requires_grad_() for t in fix_in]

        def fix():
            out = scan_sharded.fixup(*fix_in)
            torch.autograd.grad(out, fix_in, dy)
        row["fixup_ms"] = cuda_ms(fix, 3)
        fix_ms += LAYERS_PER_STAGE * 3 * row["fixup_ms"]
        log(f"K6 SP shard {name} {(R, L, D)}: fwd {row['fwd_ms']:.4f} ms "
            f"(bound {row['fwd_bound_ms']:.4f}, {row['fwd_bound_by']}), bwd "
            f"{row['bwd_ms']:.4f} ms (bound {row['bwd_bound_ms']:.4f}, "
            f"{row['bwd_bound_by']}); fix-up fwd + bwd "
            f"{row['fixup_ms']:.4f} ms"
            + (f"; plain fwd {row['fwd_plain_ms']:.2f} ms, bwd "
               f"{row['bwd_plain_ms']:.2f} ms, max_abs_err "
               f"{row['max_abs_err']:.3e}" if "max_abs_err" in row else ""))
        rows.append(row)
        del u, delta, A, B, C, y, st, dy, dlast, fix_in
        torch.cuda.empty_cache()
    log(f"fix-up per SP step and rank (3 directions x 2 layers a stage, "
        f"alone on the card): {fix_ms:.2f} ms")
    return fix_ms


def phase_parallel():
    """Phase 19 (module docstring)."""
    rows = []
    fix_ms = par_kernels(rows)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        path = os.path.join(tmp, "references.pt")
        t0 = time.perf_counter()
        par_references(path)
        log(f"  references: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        nccl, = launch(par_rank_nccl, 1, path, backend="nccl",
                       timeout_s=600, threads=4)
        log(f"(a) world 1 over {nccl['backend']}: loss {nccl['loss']:.6f}, "
            f"grad norm {nccl['grad_norm']:.6f}; largest distance from the "
            f"single-process step {nccl['worst_abs']:.3e}; launches "
            f"{nccl['counts']} ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        ranks = launch(par_rank_shared, 2, path, backend="gloo",
                       device="cuda:0", timeout_s=900, threads=4)
        log(f"(b, c) world 2 over gloo, both ranks on cuda:0: "
            f"{time.perf_counter() - t0:.1f} s")
    for name in PAR_STEPS:
        r0, r1 = ranks[0][name], ranks[1][name]
        log(f"  {name} step: worst share of the bf16 tier {r0['worst']:.3f}; "
            f"launches a step and rank {r0['counts']}; peak GiB by rank "
            f"{r0['peak_gib']:.2f}, {r1['peak_gib']:.2f}; s/step (2 ranks "
            f"sharing one H100, one step after the checked one) "
            f"{r0['sec']:.4f}, {r1['sec']:.4f}, of it in collectives "
            f"{r0['comm']['sec']:.4f}, {r1['comm']['sec']:.4f} s "
            f"({r0['comm']['calls']:.0f} calls, "
            f"{r0['comm']['bytes'] / 2 ** 30:.3f} GiB a rank)"
            + (f"; SP window launches {r0['window_counts']}"
               if name == "sp" else ""))
        log(f"  {name} f32 step (2 x 4 x 64^3): gradients' relative L2 from "
            f"its float32 reference {r0['f32_rel']:.3e} (from the plain step "
            f"{r0['f32_plain_rel']:.3e}), worst share of the f32 tier "
            f"{r0['f32_worst']:.3f}")
    lay = ranks[0]["layer"]
    log(f"  (c) f32 stage-0 MambaV3 under SP 2: max_abs_err "
        f"{lay['max_abs_err']:.3e}; launches {lay['counts']}; peak GiB by "
        f"rank {lay['peak_gib']:.2f}, {ranks[1]['layer']['peak_gib']:.2f}")
    log("  (c) by tensor, max |err| / max |ref|: " + "; ".join(
        f"{k} {e:.3e} / {m:.3e} ({e / max(m, 1e-30):.2e})"
        for k, (e, m) in sorted(lay["errs"].items(),
                                key=lambda kv: -kv[1][0])[:8]))
    return dict(rows=rows, fix_ms=fix_ms, nccl=nccl, ranks=ranks)


def par_launches(par, counter):
    """Phase 19's launches of one counter a step and rank, by path."""
    ranks = par["ranks"][0]
    out = {f"{name}_train_step_rank": ranks[name]["counts"].get(counter, 0)
           for name in PAR_STEPS}
    out["nccl_world1_step"] = par["nccl"]["counts"].get(counter, 0)
    out["sp_window_rank"] = ranks["sp"]["window_counts"].get(counter, 0)
    out["sp_stage0_layer_rank"] = ranks["layer"]["counts"].get(counter, 0)
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    device_kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{device_kind}, count {torch.cuda.device_count()}")
    # one nvcc per source, all started together (threads wait on them)
    # (K7's and K8's entries live in the two gated_scan libraries)
    loaders = (scan_mxu._lib, scan_mxu._bwd_lib, conv3d._lib,
               conv3d._dw_lib, bench_scan_lb._lib, bench_scan_flat._lib)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for f in [pool.submit(fn) for fn in loaders]:
            f.result()
    scan_proj._lib(), scan_proj._bwd_lib()
    for name in ("gated_scan_fwd", "gated_scan_bwd", "conv3d_k3s1_fwd",
                 "conv3d_k3s1_dw", "scan_lb_fwd", "scan_flat_fwd"):
        info = _build.BUILD_INFO[name]
        log(f"built {name} in {info['seconds']:.1f} s (all six sources "
            "in parallel)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"  ptxas: {line.strip()}")
    log(f"phase 1 + 1b (device, build): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    results = []
    phase_kernels(results)
    log(f"phase 2 (kernels vs plain): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    model_stats = phase_model()
    log(f"phase 3 (full-width forward): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    case_launches = phase_case()
    log(f"phase 4 (sliding-window case): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bwd_results = []
    bytes_per_elem, bwd_stage_ms = phase_backward(bwd_results)
    log(f"phase 5 (backward kernels vs plain): "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_grads()
    log(f"phase 6 (full-width gradients): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_stats = phase_train()
    log(f"phase 7 (train step): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_trainer()
    log(f"phase 8 (augmentation chains, trainer end to end): "
        f"{time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    core_results = []
    phase_core(core_results)
    phase_core_groups()
    log(f"phase 9 (K6 vs plain, N = 16 and state groups): "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lm_stats = phase_lm()
    log(f"phase 10 (Mamba LM serving, mamba-2.8b width): "
        f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    slice_results, proj_results = [], []
    phase_slice_kernel(slice_results, bytes_per_elem)
    phase_proj_kernel(proj_results)
    log(f"phase 11 (K5 and K8 vs plain): "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    comp_stats = phase_compositions()
    log(f"phase 12 (compositions: windows and the case): "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    comp_train = phase_composition_train()
    log(f"phase 13 (compositions: train step): "
        f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mxu_results = []
    phase_mxu(mxu_results)
    log(f"phase 14 (K7 vs plain, four kinds of input): "
        f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    conv_results = []
    conv_counts, conv_errs = phase_conv(conv_results)
    log(f"phase 15 (K9, the 3x3x3 conv, vs plain and cuDNN): "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_state_groups()
    log(f"phase 16 (MambaV3 at d_state 4 and 32, every composition): "
        f"{time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    probe_results = []
    probe_main = phase_probes(probe_results)
    log(f"phase 17 (K10 and K11 vs plain and K2; the twins' mains): "
        f"{time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wv_stats = phase_whole_volume(results)
    log(f"phase 18 (whole volume and case pipeline): "
        f"{time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    par = phase_parallel()
    log(f"phase 19 (parallelism: NCCL world 1, gloo world 2 on one card): "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s; ms per window "
        f"{model_stats['ms_per_window']:.2f}; s/step "
        f"{train_stats['sec']:.4f}; LM decode ms/token "
        f"{lm_stats['decode_ms']:.3f}")
    log("whole volume (s/case, peak GiB): " + "; ".join(
        f"{n} {wv_stats[n]['sec']:.4f}, {wv_stats[n]['peak_gib']:.2f}"
        for n in WV_RUNS))
    log("compositions (s/case, s/step, peak GiB of the step): " + "; ".join(
        f"{c} {comp_stats[c]['sec_per_case']:.4f}, "
        f"{comp_train[c]['sec']:.4f}, {comp_train[c]['peak_gib']:.2f}"
        for c in COMPOSITIONS))

    train_launches = train_stats["launches"]
    kernels = []
    for direction, table, rows_all in (("fwd", REPLACES, results),
                                       ("bwd", BWD_REPLACES, bwd_results)):
        for wrapper, replaces in table.items():
            rows = [r for r in rows_all if r["wrapper"] == wrapper]
            main_row = next(r for r in rows if r["shape"] == "stage0"
                            and r["dtype"] == "bfloat16")
            if direction == "fwd":
                bound, bound_by = scan_bound(
                    "fwd", main_row["variant"], *SHAPES["stage0"],
                    torch.bfloat16)
                launches = case_launches[wrapper]
                by_path = {"inference_case": launches,
                           "train_5_steps": train_launches[wrapper],
                           "train_5_steps_device_aug":
                               train_stats["aug_launches"][wrapper]}
                by_path.update({name: wv_stats[name]["launches"][wrapper]
                                for name in WV_RUNS})
                by_path["deploy_case"] = wv_stats["deploy"]["launches"][
                    wrapper]
                by_path.update(par_launches(par, wrapper))
                extra = dict(wholevol_shapes={
                    f"{r['shape']} {r['dtype']} {r['variant']}": dict(
                        {k: r[k] for k in ("ms", "plain_ms", "max_abs_err")},
                        **dict(zip(("bound_ms", "bound_by"), scan_bound(
                            "fwd", r["variant"], *WV_SHAPES[r["shape"]],
                            getattr(torch, r["dtype"])))))
                    for r in rows if r["shape"] in WV_SHAPES})
            else:
                bound, bound_by = main_row["bound_ms"], main_row["bound_by"]
                launches = train_launches[f"{wrapper}_bwd"]
                by_path = {"train_5_steps": launches,
                           "train_5_steps_device_aug":
                               train_stats["aug_launches"][f"{wrapper}_bwd"],
                           **par_launches(par, f"{wrapper}_bwd")}
                extra = dict(
                    device_ms=main_row.get("device_ms"),
                    device_ms_by_variant={
                        r["variant"]: r.get("device_ms") for r in rows
                        if r["shape"] == "stage0"
                        and r["dtype"] == "bfloat16"},
                    stage_ms={v: bwd_stage_ms[v] for v in VARIANTS
                              if VARIANTS[v][0] == wrapper})
            kernels.append(dict(
                name=f"gated_scan_{direction}[{wrapper}]", route="cuda",
                source=SOURCES[direction], replaces=replaces,
                launches=launches, max_abs_err=max(
                    r["max_abs_err"] for r in rows),
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=bound, bound_by=bound_by, library_ms=None,
                variant=main_row["variant"], launches_by_path=by_path,
                **extra))
    for direction in ("fwd", "bwd"):
        rows = [r for r in core_results if r["direction"] == direction]
        main_row = next(r for r in rows if r["shape"] == "prefill")
        counter = "scan_core" + ("" if direction == "fwd" else "_bwd")
        if direction == "fwd":
            by_path = {"lm_generate": lm_stats["gen_counts"]["scan_core"],
                       "lm_prefill_f32":
                           lm_stats["prefill_counts"]["scan_core"]}
            launches = by_path["lm_generate"]
        else:
            launches = lm_stats["grad_counts"]["scan_core_bwd"]
            by_path = {"lm_prefill_grad": launches}
        by_path.update(par_launches(par, counter))
        kernels.append(dict(
            name=f"gated_scan_{direction}[scan_core]", route="cuda",
            source=SOURCES[direction], replaces=CORE_REPLACES[direction],
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None, variant="core", launches_by_path=by_path,
            sp_shard_shapes={r["shape"]: {
                "R_L_D": [r["R"], r["L"], r["D"]],
                "ms": r[f"{direction}_ms"],
                "bound_ms": r[f"{direction}_bound_ms"],
                "bound_by": r[f"{direction}_bound_by"],
                **({"plain_ms": r[f"{direction}_plain_ms"],
                    "max_abs_err": r["max_abs_err"]}
                   if "max_abs_err" in r else {})} for r in par["rows"]},
            **({"device_ms": main_row.get("device_ms")}
               if direction == "bwd" else {})))
    for direction in ("fwd", "bwd"):
        rows = [r for r in slice_results if r["direction"] == direction]
        main_row = next(r for r in rows if r["stage"] == "stage0"
                        and r["R"] == (1 if direction == "fwd" else 2)
                        and r["dtype"] == "bfloat16")
        if direction == "fwd":
            by_path = {"inference_case": comp_stats["dir_slice"][
                "case_counts"]["scan_dir_slice"]}
        else:
            by_path = {"train_step": comp_train["dir_slice"]["counts"][
                "scan_dir_slice_bwd"]}
        kernels.append(dict(
            name=f"gated_scan_{direction}[scan_dir_slice]", route="cuda",
            source=SOURCES[direction], replaces=SLICE_REPLACES[direction],
            launches=next(iter(by_path.values())),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None, variant="slice", launches_by_path=by_path,
            **({"device_ms": main_row.get("device_ms")}
               if direction == "bwd" else {})))
    for direction in ("fwd", "bwd"):
        rows = [r for r in proj_results if r["direction"] == direction]
        main_R, other_R = (2, 1) if direction == "fwd" else (1, 2)
        at = lambda R: next(r for r in rows if r["R"] == R
                            and r["variant"] == "forward_acc_gate"
                            and r["dtype"] == "bfloat16")
        main_row, other = at(main_R), at(other_R)
        if direction == "fwd":
            by_path = {"inference_case": comp_stats["proj"]["case_counts"][
                "scan_proj"], "train_step": comp_train["proj"]["counts"][
                "scan_proj"]}
        else:
            by_path = {"train_step": comp_train["proj"]["counts"][
                "scan_proj_bwd"]}
        kernels.append(dict(
            name=f"proj_scan_{direction}[scan_proj]", route="cuda",
            source=SOURCES[direction], replaces=PROJ_REPLACES[direction],
            kernel=f"proj_{direction}_kernel",
            launches=next(iter(by_path.values())),
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if "max_abs_err" in r),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None, variant=main_row["variant"], R=main_R,
            device_ms=main_row.get("device_ms"),
            device_parts=main_row.get("device_parts"),
            **{f"R{other_R}": {k: other[k] for k in (
                "ms", "bound_ms", "bound_by")}},
            launches_by_path=by_path,
            **({"layer_split": comp_train["mxu"]["layer_split"].get("proj")}
               if direction == "bwd" else {})))
    for direction in ("fwd", "bwd"):
        rows = [r for r in mxu_results if r["direction"] == direction]
        main_row = next(r for r in rows if r["shape"] == "prefill"
                        and r["kind"] == "model")
        stage0 = next(r for r in rows if r["shape"] == "stage0_r2"
                      and r["kind"] == "model")
        if direction == "fwd":
            by_path = {
                "lm_prefill_f32": lm_stats["mxu_prefill_counts"]["scan_mxu"],
                "lm_forward_f32": lm_stats["mxu_fwd_counts"]["scan_mxu"],
                "lm_generate_bf16": lm_stats["mxu_gen_counts"]["scan_mxu"],
                "segmamba_window": comp_stats["mxu"]["counts"]["scan_mxu"],
                "inference_case":
                    comp_stats["mxu"]["case_counts"]["scan_mxu"],
                "train_step": comp_train["mxu"]["counts"]["scan_mxu"]}
            launches = by_path["lm_prefill_f32"]
        else:
            by_path = {
                "lm_prefill_grad":
                    lm_stats["mxu_grad_counts"]["scan_mxu_bwd"],
                "train_step": comp_train["mxu"]["counts"]["scan_mxu_bwd"]}
            launches = by_path["lm_prefill_grad"]
        kernels.append(dict(
            name=f"mxu_scan_{direction}[scan_mxu]", route="cuda",
            source=SOURCES[direction], replaces=MXU_REPLACES[direction],
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None, variant="ratio_form_guarded",
            k6_ms=main_row["k6_ms"], ratio_share=main_row["share"],
            device_ms=main_row["device_ms"],
            stage0_r2={k: stage0[k] for k in (
                "ms", "device_ms", "k6_ms", "plain_ms", "bound_ms")},
            launches_by_path=by_path,
            **({"layer_split": comp_train["mxu"]["layer_split"]}
               if direction == "bwd" else {})))
    main_row = conv_results[0]     # 128^3 48 -> 48, the decoder's conv
    for direction, pre, counter in (("fwd", "", "conv3d"),
                                    ("dw", "dw_", "conv3d_dw")):
        kernels.append(dict(
            name=f"conv3d_k3s1_{direction}[conv3d]", route="cuda",
            source=CONV_SOURCES[direction],
            replaces=CONV_REPLACES[direction],
            launches=conv_counts[counter],
            max_abs_err=conv_errs[direction],
            ms=main_row[f"{pre}ms"], plain_ms=main_row[f"{pre}plain_ms"],
            bound_ms=main_row[f"{pre}bound_ms"],
            bound_by=main_row[f"{pre}bound_by"],
            library_ms=main_row[f"{pre}library_ms"], variant="bf16",
            shape=main_row["shape"],
            device_ms=main_row[f"{pre}device_ms"],
            library_device_ms=main_row[f"{pre}library_device_ms"],
            shapes=[{k: r[k] for k in (
                "shape", f"{pre}ms", f"{pre}device_ms", f"{pre}plain_ms",
                f"{pre}library_ms", f"{pre}library_device_ms",
                f"{pre}bound_ms", f"{pre}bound_by", "fwd_bwd_ms",
                "library_fwd_bwd_ms")} for r in conv_results],
            launches_by_path={"bench_conv_fwd_bwd": conv_counts[counter],
                              "bench_conv_main":
                                  conv_counts[f"twin_{counter}"]}))
    for probe in ("noshift", "nohs", "flat"):
        rows = [r for r in probe_results if r["kind"] == probe]
        main_row = next(r for r in rows if r["R"] == 1
                        and r["dtype"] == "bfloat16")
        launches = (probe_main["variants"][probe] if probe != "flat"
                    else probe_main["counts"]["scan_flat"])
        extra = {k: main_row[k] for k in ("k2_ms", "device_ms",
                                           "k2_device_ms") if k in main_row}
        if probe == "flat":
            r3 = next(r for r in rows if r["R"] == 3
                      and r["dtype"] == "bfloat16")
            extra["R3"] = {k: r3[k] for k in ("ms", "k2_ms", "plain_ms",
                                              "bound_ms", "bound_by")}
        kernels.append(dict(
            name=f"{PROBE_SOURCES[probe].rsplit('/', 1)[1][:-3]}[{probe}]",
            route="cuda", source=PROBE_SOURCES[probe],
            replaces=PROBE_REPLACES[probe], launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None, variant=probe, **extra,
            launches_by_path={"twins_mains": launches}))
    for k in kernels:   # the unit that binds, and its kind for the record
        k["bound_unit"] = k["bound_by"]
        k["bound_by"] = bound_kind(k["bound_by"])
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--breakdown"] and len(sys.argv) == 3:
        breakdown_child_main(sys.argv[2])
    else:
        main()
