"""Port twins of the JAX package's benchmark scripts that hold TPU kernels.

- ``bench_scan_lb``: the lower-bound probe of the fused forward scan (K10,
  ``benchmarks/bench_scan_lb.py``), its Hopper kernel
  ``csrc/scan_lb_fwd.cu``.
- ``bench_scan_flat``: the fused forward scan with its states spread over
  threads (K11, ``benchmarks/bench_scan_flat.py``), its Hopper kernel
  ``csrc/scan_flat_fwd.cu``.
- ``bench_conv``: the 3x3x3 conv K9 (``benchmarks/bench_conv.py``) beside
  the library conv at the decoder's shapes, its Hopper kernels
  ``csrc/conv3d_k3s1_fwd.cu`` and ``csrc/conv3d_k3s1_dw.cu`` through
  ``ops.conv3d``.
- ``microbench``: ``chain_time``, the timing helper all three use.

Each runs as ``python -m segmamba_tpu_torch.benchmarks.<name>`` (on the card
by default, ``--device cpu`` for the plain versions at small shapes).
Importing this package builds nothing.
"""
