"""The Hopper scan kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA card and carries the ``cuda`` marker; the
``cuda`` fixture skips it where ``torch.cuda.is_available()`` is false (it
decides at run time, never while the module is imported). This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

Tolerances: float32 I/O rtol 6e-4 / atol 2e-3, bfloat16 I/O compared in
float32 at rtol 3e-2 / atol 5e-2 (the port's f32 and bf16 tiers); chunk
exit states are float32 either way and use the f32 tier.
"""

import itertools

import numpy as np
import pytest
import torch

from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.ops import scan_dir, scan_fused

pytestmark = pytest.mark.cuda

N = 16
TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}
F32 = TOL[torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, R, L, D, dtype, per_row, strided, device):
    """Numpy-seeded operands; ``strided`` makes z a half of xz and B/C
    column slices of an x_dbl with 3 + 2N columns, as the model passes."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32)).to(device)
    u, dt, acc = f(R, L, D), f(R, L, D, sc=0.5), f(R, L, D)
    if strided:
        z = f(R, L, 2 * D)[..., D:]
        xdbl = f(R, L, 3 + 2 * N)
        B, C = xdbl[..., 3:3 + N], xdbl[..., 3 + N:]
    else:
        z, B, C = f(R, L, D), f(R, L, N), f(R, L, N)
    pshape = (R, D) if per_row else (D,)
    A = -torch.exp(f(*pshape, N))
    seq = [t.to(dtype) for t in (u, dt, z, acc, B, C)]
    return (*seq, A, f(*pshape), f(*pshape, sc=0.3))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol[0],
                               atol=tol[1])


FLAGS = [(True, False, False), (False, True, True), (False, True, False),
         (False, False, True), (True, True, True)]


@pytest.mark.parametrize("reverse,gate,has_acc", FLAGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_dir_kernel_matches_plain(cuda, reverse, gate, has_acc, dtype):
    for (R, L, D), per_row, strided in itertools.product(
            [(2, 320, 96), (1, 200, 50), (1, 64, 136), (2, 7, 33)],
            [True, False], [False, True]):
        u, dt, z, acc, B, C, A, Dv, bias = _inputs(
            0, R, L, D, dtype, per_row, strided, cuda)
        kw = dict(acc=acc if has_acc else None, gate=gate, reverse=reverse,
                  return_states=True)
        args = (u, dt, z if gate else None, A, B, C, Dv, bias)
        got, st = scan_dir.mamba_scan_fused_dir(*args, **kw)
        want, st_ref = scan_dir.mamba_scan_fused_dir_ref(*args, **kw)
        assert got.dtype == dtype and got.shape == (R, L, D)
        _close(got, want, TOL[dtype])
        _close(st, st_ref, F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk_size", [128, 32])
def test_scan_fused_kernel_matches_plain(cuda, dtype, chunk_size):
    for (R, L, D), per_row in itertools.product(
            [(2, 320, 96), (1, 200, 50), (3, 1000, 192)], [False, True]):
        u, dt, z, _, B, C, A, Dv, bias = _inputs(
            1, R, L, D, dtype, per_row, True, cuda)
        args = (u, dt, z, A, B, C, Dv, bias)
        got, st = scan_fused.mamba_scan_fused(*args, chunk_size=chunk_size,
                                              return_states=True)
        want, st_ref = scan_fused.mamba_scan_fused_ref(
            *args, chunk_size=chunk_size, return_states=True)
        _close(got, want, TOL[dtype])
        _close(st, st_ref, F32)


def test_launch_counters_count_kernel_calls(cuda):
    u, dt, z, _, B, C, A, Dv, bias = _inputs(2, 1, 256, 64, torch.float32,
                                             False, False, cuda)
    before = scan_dir.LAUNCHES, scan_fused.LAUNCHES
    scan_dir.mamba_scan_fused_dir(u, dt, None, A, B, C, Dv, bias,
                                  reverse=True, gate=False)
    scan_fused.mamba_scan_fused(u, dt, z, A, B, C, Dv, bias)
    scan_fused.mamba_scan_fused_ref(u, dt, z, A, B, C, Dv, bias)
    assert (scan_dir.LAUNCHES, scan_fused.LAUNCHES) == (before[0] + 1,
                                                        before[1] + 1)


def test_kernel_rejects_unsupported_operands(cuda):
    u, dt, z, _, B, C, A, Dv, bias = _inputs(3, 1, 64, 32, torch.float32,
                                             False, False, cuda)
    with pytest.raises(ValueError, match="N=16"):
        scan_fused.mamba_scan_fused(u, dt, z, A[:, :8], B[..., :8],
                                    C[..., :8], Dv, bias)
    with pytest.raises(ValueError, match="unit stride"):
        scan_fused.mamba_scan_fused(u.transpose(1, 2).contiguous()
                                    .transpose(1, 2), dt, z, A, B, C, Dv,
                                    bias)
    with pytest.raises(ValueError, match="dtype|bfloat16|float"):
        scan_fused.mamba_scan_fused(u, dt.to(torch.bfloat16), z, A, B, C, Dv,
                                    bias)


def test_tiny_segmamba_kernel_path_matches_plain(cuda):
    """The whole forward at the tiny config: kernels vs plain scans."""
    cfg = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
               feat_size=(4, 8, 16, 32), hidden_size=64,
               num_slices_list=(8, 4, 2, 1))
    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     device=cuda, **cfg).eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2, 32, 32, 32)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        got = model(x)
        saved = scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused
        scan_dir.mamba_scan_fused_dir = scan_dir.mamba_scan_fused_dir_ref
        scan_fused.mamba_scan_fused = scan_fused.mamba_scan_fused_ref
        try:
            want = model(x)
        finally:
            scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused = saved
    scale = float(want.abs().max())
    _close(got, want, (2e-3, 1e-2 * scale))
