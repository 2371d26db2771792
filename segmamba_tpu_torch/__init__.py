"""segmamba_tpu_torch — the PyTorch / CUDA port of ``segmamba_tpu``.

The JAX package ``segmamba_tpu`` is the reference; this package mirrors its
layout and is held against it by ``tests/test_torch_port_*.py``:

- ``ops``      — plain-PyTorch selective scan, causal conv1d, mamba inner op,
                 and the wrappers of the hand-written Hopper scan kernels
                 (``csrc/gated_scan_fwd.cu``, ``csrc/gated_scan_bwd.cu``,
                 built lazily by ``ops/_build.py`` on first launch, never on
                 import), differentiable through ``torch.autograd``.
- ``models``   — ``nn.Module``s: tri-oriented Mamba, GSC, encoder, UNETR
                 blocks and the full SegMamba (with remat), with the
                 reference torch ``state_dict`` names.
- ``infer``    — sliding-window inference with gaussian blending and
                 window-level mirror TTA.
- ``train``    — losses, LR schedules, the train state and step (the optax
                 SGD chain), checkpoints, the Trainer;
                 ``python -m segmamba_tpu_torch.train``.
- ``data``     — copies of the JAX package's dataset, patch sampler,
                 host augmentation, loader and SDM/edge dataset (numpy +
                 scipy), and the on-device augmentation chain
                 (``augment_device``, torch on the batch's device).
- ``native``   — the C++/OpenMP host resampler and crop of the data path
                 (a copy of the JAX package's source), built with g++ on
                 first use.
- ``examples`` — the dataset recipes (AbdomenAtlas, AIIB23, Liver-2017).
- ``utils``    — flax param tree <-> ``state_dict`` bridge, metric logging,
                 determinism, step timing.
- ``inference`` — ``python -m segmamba_tpu_torch.inference``: model forward
                 or the bench case's sliding-window inference on one card.
- ``benchmarks`` — twins of the JAX package's benchmark scripts: the scan
                 probes K10 (``bench_scan_lb``) and K11
                 (``bench_scan_flat``), with their Hopper kernels
                 (``csrc/scan_lb_fwd.cu``, ``csrc/scan_flat_fwd.cu``), the
                 conv (``bench_conv``) and the training-dynamics drive
                 (``train_dynamics``).

Layouts: ``ops`` keep the JAX package's time-major ``(R, L, D)`` sequences
and ``(R, L, N)`` B/C; ``models``, ``infer``, ``train`` and ``data`` use
torch's NCDHW volumes. The package imports torch, numpy and scipy only.
"""

__version__ = "0.1.0"
