"""The port's 3x3x3 stride-1 SAME conv (K9, ``segmamba_tpu_torch.ops.conv3d``)
vs the JAX package's ``conv3d_k3s1`` / ``conv3d_k3s1_v2``, on the CPU.

Same numpy inputs (seeded) to both; JAX runs its Pallas kernels in
interpret mode through their custom VJPs (forward, dx through the same
kernel on flipped weights, dw through ``_dw_kernel``); the port runs its
plain versions (CPU tensors), through ``_Conv3dK3S1`` for the gradients.
Shapes: Cin = 4 (encoder1's ragged K = 108), ragged H (7 and 6), B = 2.
Float32 tolerance rtol 1e-5 / atol 2e-5: tighter than the f32 tier
(6e-4 / 2e-3), since both sides sum float32 products and differ only in
order (measured: 1.5e-6 on y and dx, 2.2e-5 on dw at |dw| up to 43).
bfloat16 forward at the bf16 tier (3e-2 / 5e-2): JAX rounds its P tile to
bf16 before the 9-term sum, the port rounds once. The CUDA kernels are held against these plain versions on
the card (tests/test_torch_port_cuda.py, chip_smoke.py phase 15).

CPU time: about 15 s (interpret-mode JAX forward and VJP per shape).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.ops import conv3d_pallas as jc
from segmamba_tpu_torch.ops import conv3d

TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=5e-2)
SHAPES = [(1, 3, 7, 9, 4, 6), (2, 3, 6, 5, 8, 5)]   # B, D, H, W, Cin, Cout


def _inputs(seed, B, D, H, W, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, cin)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 3, cin, cout))).astype(np.float32)
    dy = rng.standard_normal((B, D, H, W, cout)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("v2", [False, True])
def test_conv3d_fwd_dx_dw_match_jax(shape, v2):
    """Forward, dx and dw: the port's autograd Function on CPU tensors (its
    plain versions) against JAX's Pallas kernels through ``jax.vjp``."""
    x, w, dy = _inputs(sum(shape) + v2, *shape)
    jfn = jc.conv3d_k3s1_v2 if v2 else jc.conv3d_k3s1
    y_j, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    fn = conv3d.conv3d_k3s1_v2 if v2 else conv3d.conv3d_k3s1
    y = fn(tx, tw)
    assert y.grad_fn is not None and y.dtype == torch.float32
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_j), **TOL)


def test_plain_versions_match_torch_conv3d():
    """The plain versions against ``F.conv3d`` and its weight gradient
    (the yardstick the card times, not used by the port), float32."""
    x, w, dy = _inputs(3, 2, 4, 7, 6, 4, 6)
    tx, tw, tdy = map(torch.from_numpy, (x, w, dy))
    ncdhw = lambda t: t.permute(0, 4, 1, 2, 3)
    wt = tw.permute(4, 3, 0, 1, 2)          # (Cout, Cin, kd, kh, kw)
    want = torch.nn.functional.conv3d(ncdhw(tx), wt, padding=1)
    got = conv3d.conv3d_k3s1_ref(tx, tw)
    np.testing.assert_allclose(ncdhw(got).numpy(), want.numpy(), **TOL)
    want_dw = torch.nn.grad.conv3d_weight(ncdhw(tx), wt.shape, ncdhw(tdy),
                                          padding=1)
    np.testing.assert_allclose(
        conv3d.conv3d_k3s1_dw_ref(tx, tdy).permute(4, 3, 0, 1, 2).numpy(),
        want_dw.numpy(), **TOL)


def test_bf16_forward_matches_jax_at_bf16_tier():
    x, w, _ = _inputs(5, 1, 3, 7, 9, 4, 6)
    y_j = jc.conv3d_k3s1(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(w, jnp.bfloat16))
    y = conv3d.conv3d_k3s1(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_j.astype(jnp.float32)),
                               **BF16_TOL)


def test_supported_matches_jax():
    """``conv3d_k3s1_supported`` gives JAX's answer on a grid of shapes."""
    xs = [(1, 8, 8, 8, c) for c in (4, 48, 192, 193)] + [(8, 8, 8, 48),
                                                         (1, 0, 8, 8, 48)]
    ws = [(3, 3, 3, ci, co) for ci in (4, 48, 192, 200)
          for co in (48, 192, 193)] + [(3, 3, 1, 48, 48), (3, 3, 48, 48),
                                       (1, 1, 1, 48, 48)]
    for xs_ in xs:
        for ws_ in ws:
            assert (conv3d.conv3d_k3s1_supported(xs_, ws_)
                    == jc.conv3d_k3s1_supported(xs_, ws_)), (xs_, ws_)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: both counters stay where they
    were, forward and backward, v1 and v2."""
    x, w, dy = _inputs(6, 1, 2, 5, 5, 4, 3)
    before = conv3d.LAUNCHES, conv3d.DW_LAUNCHES
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    for fn in (conv3d.conv3d_k3s1, conv3d.conv3d_k3s1_v2):
        fn(tx, tw).backward(torch.from_numpy(dy))
        with torch.no_grad():
            fn(tx, tw)
    assert (conv3d.LAUNCHES, conv3d.DW_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        conv3d._launch(tx.detach(), tw.detach())


@pytest.mark.parametrize("cin,cout,flip", [(20, 6, False), (4, 48, False),
                                           (24, 200, True), (8, 3, True)])
def test_pack_weights_ref_layout(cin, cout, flip):
    """The plain version of the bf16 kernel's packed weights holds w[kd,
    kh, kw, ci, co] (cast to bf16) at [n tile][kd][16-channel chunk][tap
    kh kw][8-channel group][n][8], zeros beyond (cin, cout); with ``flip``
    it packs ``_flip_w`` of a forward's (3, 3, 3, cout, cin) weights."""
    rng = np.random.default_rng(cin + cout)
    shape = (3, 3, 3, cout, cin) if flip else (3, 3, 3, cin, cout)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    n, ntn = conv3d._pick_n(cout)
    nch = -(-cin // 16)
    wp = conv3d.pack_weights_ref(w, cin, cout, n, flip)
    assert wp.dtype == torch.bfloat16
    assert wp.numel() == ntn * 3 * nch * 9 * 2 * n * 8
    got = wp.reshape(ntn, 3, nch, 3, 3, 2, n, 8).float().numpy()
    wf = (conv3d._flip_w(w) if flip else w).to(torch.bfloat16).float()
    want = np.zeros_like(got)
    for ci in range(cin):
        for co in range(cout):
            want[co // n, :, ci // 16, :, :, ci % 16 // 8, co % n, ci % 8] = \
                wf[:, :, :, ci, co].numpy()
    np.testing.assert_array_equal(got, want)
    if flip:   # dx weights: tap (kd, kh, kw) of channel pair (ci, co)
        assert got[0, 0, 0, 0, 1, 0, 2, 1] == wf[0, 0, 1, 1, 2] == \
            w[2, 2, 1, 2, 1].to(torch.bfloat16).float()


def test_channel_tiles_and_dw_plan():
    """The bf16 forward's output-channel tile takes the whole Cout up to
    192 (then the least padding over tiles of 64 or more); dw's
    input-channel tile divides Cin (or holds it) at
    ``benchmarks/bench_conv.py``'s shapes, and the plan puts about one wave
    of blocks on a 132-SM card there, with at least as many units as
    parts."""
    assert [conv3d._pick_n(c) for c in (4, 6, 8, 24, 48, 96, 192, 200,
                                         384)] == [
        (16, 1), (16, 1), (16, 1), (32, 1), (48, 1), (96, 1), (192, 1),
        (128, 2), (192, 2)]
    for s, cin, cout in [(128, 48, 48), (128, 96, 48), (128, 4, 48),
                         (64, 96, 96), (64, 192, 96), (32, 192, 192)]:
        nci, nparts, dsplit, units = conv3d._dw_plan((1, s, s, s, cin),
                                                     cout, 132)
        blocks = nparts * -(-cin // nci) * -(-cout // 64)
        assert (cin % nci == 0 or cin < nci) and 1 <= dsplit <= s
        assert nci in (8, 16, 24) and units >= nparts
        assert 100 <= blocks <= 132
