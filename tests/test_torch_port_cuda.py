"""The Hopper scan kernels against their plain PyTorch versions, on the card
(K1-K4 through ``scan_dir`` / ``scan_fused``, K5 through
``scan_dir.mamba_scan_fused_slice``, K6 through ``scan_core``, K7 through
``scan_mxu``, K8 through ``scan_proj``).

Every test here needs an NVIDIA card and carries the ``cuda`` marker; the
``cuda`` fixture skips it where ``torch.cuda.is_available()`` is false (it
decides at run time, never while the module is imported). This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

Tolerances: float32 I/O rtol 6e-4 / atol 2e-3, bfloat16 I/O compared in
float32 at rtol 3e-2 / atol 5e-2 (the port's f32 and bf16 tiers); chunk
exit states are float32 either way and use the f32 tier. Gradients use the
same tiers with the absolute part scaled by max(1, max|plain|) of each
gradient: dA, dD, dbias, dB and dC are sums over steps or channels that
the kernel and the plain backward take in different orders.
"""

import itertools

import numpy as np
import pytest
import torch

from segmamba_tpu_torch.models import MambaLMHeadModel, SegMamba
from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.ops import (
    scan_core,
    scan_dir,
    scan_fused,
    scan_mxu,
    scan_proj,
)
from segmamba_tpu_torch.ops.selective_scan import selective_scan

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
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(),
                               rtol=tol[0], atol=tol[1])


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


def _grad_close(name, got, want, tol):
    want = want.float()
    atol = tol[1] * max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=tol[0], atol=atol,
                               err_msg=name)


GRADS = ("du", "ddt", "dz", "dacc", "dA", "dB", "dC", "dD", "dbias")


@pytest.mark.parametrize("reverse,gate,has_acc", FLAGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_dir_backward_kernel_matches_plain(cuda, reverse, gate,
                                                has_acc, dtype):
    """Every gradient of the backward kernel against the plain backward,
    through the autograd Function; ragged L and D, shared and per-row
    parameters, strided operands, chunks of 128 and 32."""
    for (R, L, D, T), per_row, strided in itertools.product(
            [(2, 320, 96, 128), (1, 200, 50, 128), (1, 64, 136, 128),
             (2, 7, 33, 128), (2, 300, 40, 32)],
            [True, False], [False, True]):
        u, dt, z, acc, B, C, A, Dv, bias = _inputs(
            5, R, L, D, dtype, per_row, strided, cuda)
        dout = torch.randn(R, L, D, device=cuda).to(dtype)
        zz = z if gate else None
        a = acc if has_acc else None
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in (u, dt, zz, a, A, B, C, Dv, bias)]
        lu, ldt, lz, la, lA, lB, lC, lD, lb = leaves
        out = scan_dir.mamba_scan_fused_dir(lu, ldt, lz, lA, lB, lC, lD, lb,
                                            acc=la, gate=gate,
                                            reverse=reverse, chunk_size=T)
        out.backward(dout)
        want = scan_dir.mamba_scan_fused_dir_bwd_ref(
            u, dt, zz, A, B, C, Dv, bias, dout, acc=a, gate=gate,
            reverse=reverse, chunk_size=T)
        for name, leaf, w in zip(GRADS, leaves, want):
            if leaf is None:
                assert w is None
                continue
            assert leaf.grad.dtype == leaf.dtype
            assert leaf.grad.shape == leaf.shape
            _grad_close(f"{name} {(R, L, D, T)} per_row={per_row}",
                        leaf.grad, w, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_fused_backward_kernel_matches_plain(cuda, dtype):
    for (R, L, D), per_row in itertools.product(
            [(2, 320, 96), (1, 200, 50), (3, 1000, 192)], [False, True]):
        u, dt, z, _, B, C, A, Dv, bias = _inputs(
            6, R, L, D, dtype, per_row, True, cuda)
        dout = torch.randn(R, L, D, device=cuda).to(dtype)
        leaves = [t.detach().requires_grad_()
                  for t in (u, dt, z, A, B, C, Dv, bias)]
        scan_fused.mamba_scan_fused(*leaves).backward(dout)
        want = scan_fused.mamba_scan_fused_bwd_ref(u, dt, z, A, B, C, Dv,
                                                   bias, dout)
        want = [w for w in want if w is not None]
        for name, leaf, w in zip(("du", "ddt", "dz", "dA", "dB", "dC", "dD",
                                  "dbias"), leaves, want):
            _grad_close(f"{name} {(R, L, D)}", leaf.grad, w, TOL[dtype])


def test_cuda_forward_records_gradient(cuda):
    """The repair of the first slice's silent gradient loss: a CUDA forward
    through each wrapper with inputs that require grad has a ``grad_fn``,
    launches the backward kernel once per call, and its gradients are the
    plain backward's. Under ``inference_mode`` nothing is recorded."""
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(7, 2, 256, 64, torch.float32,
                                               False, True, cuda)
    dout = torch.randn(2, 256, 64, device=cuda)
    calls = {
        "scan_dir": (scan_dir, scan_dir.mamba_scan_fused_dir,
                     dict(acc=acc, gate=True), scan_dir.
                     mamba_scan_fused_dir_bwd_ref),
        "scan_fused": (scan_fused, scan_fused.mamba_scan_fused, {},
                       scan_fused.mamba_scan_fused_bwd_ref),
    }
    for name, (mod, fn, kw, bwd_ref) in calls.items():
        lA = A.detach().requires_grad_()
        before = mod.LAUNCHES, mod.BWD_LAUNCHES
        out = fn(u, dt, z, lA, B, C, Dv, bias, **kw)
        assert out.grad_fn is not None, name
        out.backward(dout)
        assert (mod.LAUNCHES, mod.BWD_LAUNCHES) == (before[0] + 1,
                                                    before[1] + 1), name
        ref_kw = {"acc": acc, "gate": True} if name == "scan_dir" else {}
        want = bwd_ref(u, dt, z, A, B, C, Dv, bias, dout, **ref_kw)[4]
        _grad_close(f"{name} dA", lA.grad, want, F32)
        with torch.inference_mode():
            out = fn(u, dt, z, lA, B, C, Dv, bias, **kw)
        assert out.grad_fn is None and mod.BWD_LAUNCHES == before[1] + 1


def _param_grads(model, x, labels):
    model.zero_grad(set_to_none=True)
    logits = model(x)
    torch.nn.functional.cross_entropy(logits, labels).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def test_tiny_segmamba_grads_kernel_path_matches_plain(cuda):
    """Every parameter gradient of the tiny model (f32): the kernel path
    against the same model on the plain scans: all together within 1e-3
    relative L2 (two plain compositions of the same math differ by ~5e-5),
    and each within rtol 2e-3 / atol 5e-2 of the larger of the
    parameter's own largest |gradient| and 1e-3 of the model's. The
    per-parameter bound is a wiring check: a conv bias followed by
    instance norm has a gradient that is zero up to rounding, and the
    deepest blocks' instance norms over a few voxels amplify rounding (two
    plain compositions of the same math already differ there by percents
    of such a parameter's scale)."""
    cfg = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
               feat_size=(4, 8, 16, 32), hidden_size=64,
               num_slices_list=(8, 4, 2, 1))
    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     device=cuda, **cfg)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 2, 32, 32, 32)).astype(
        np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 3, (2, 32, 32, 32))).to(cuda)
    before = scan_dir.BWD_LAUNCHES, scan_fused.BWD_LAUNCHES
    got = _param_grads(model, x, labels)
    assert (scan_dir.BWD_LAUNCHES - before[0],
            scan_fused.BWD_LAUNCHES - before[1]) == (8, 4)
    saved = scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused
    scan_dir.mamba_scan_fused_dir = scan_dir.mamba_scan_fused_dir_ref
    scan_fused.mamba_scan_fused = scan_fused.mamba_scan_fused_ref
    try:
        want = _param_grads(model, x, labels)
    finally:
        scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused = saved
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-3 * top)
        _close(got[k], w, (2e-3, 5e-2 * scale))
    diff = sum(float((got[k] - w).double().square().sum())
               for k, w in want.items())
    norm = sum(float(w.double().square().sum()) for w in want.values())
    assert (diff / norm) ** 0.5 <= 1e-3


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


def _core_inputs(seed, R, L, D, device, N_=N):
    """K6's float32 operands: positive delta (softplus already applied),
    B and C column slices of an x_dbl, as the LM's prefill passes them."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32)).to(device)
    u = f(R, L, D)
    delta = torch.nn.functional.softplus(f(R, L, D, sc=0.5) - 1.0)
    xdbl = f(R, L, 5 + 2 * N_)
    A = -torch.exp(f(D, N_, sc=0.5))
    return u, delta, A, xdbl[..., 5:5 + N_], xdbl[..., 5 + N_:]


@pytest.mark.parametrize("R,L,D,T", [(2, 256, 96, 128), (1, 200, 50, 128),
                                     (2, 300, 136, 32), (1, 64, 40, 128)])
def test_scan_core_kernel_matches_plain(cuda, R, L, D, T):
    """K6 forward (y, chunk states, last state) and backward (du, ddelta,
    dA, dB, dC with a nonzero gradient of the last state), ragged L and D,
    one chunk and many."""
    u, delta, A, B, C = _core_inputs(9, R, L, D, cuda)
    y, st = scan_core._launch(u, delta, A, B, C, T)
    y_p, st_p = scan_core.selective_scan_core_ref(u, delta, A, B, C, T,
                                                  return_states=True)
    _close(y, y_p, F32)
    _close(st, st_p, F32)
    dy = torch.randn(R, L, D, device=cuda)
    dlast = torch.randn(R, D, N, device=cuda)
    leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
    before = scan_core.BWD_LAUNCHES
    yk, last = scan_core._ScanCore.apply(T, *leaves)
    _close(last, scan_core._last_state(st_p), F32)
    torch.autograd.backward((yk, last), (dy, dlast))
    assert scan_core.BWD_LAUNCHES == before + 1
    want = scan_core.selective_scan_core_bwd_ref(u, delta, A, B, C, dy,
                                                 dlast, T)
    for name, leaf, w in zip(("du", "ddelta", "dA", "dB", "dC"), leaves,
                             want):
        _grad_close(f"{name} {(R, L, D, T)}", leaf.grad, w, F32)


def test_selective_scan_on_cuda_records_gradient(cuda):
    """``selective_scan`` on CUDA tensors launches K6 forward, has a
    ``grad_fn``, and its backward launches K6 backward once."""
    u, delta, A, B, C = _core_inputs(10, 2, 200, 64, cuda)
    lu = u.detach().requires_grad_()
    before = scan_core.LAUNCHES, scan_core.BWD_LAUNCHES
    y, last = selective_scan(lu, delta, A, B, C, D=torch.ones(64,
                                                              device=cuda),
                             delta_softplus=True, return_last_state=True)
    assert y.grad_fn is not None and last.grad_fn is not None
    (y.sum() + last.square().sum()).backward()
    assert (scan_core.LAUNCHES, scan_core.BWD_LAUNCHES) == (before[0] + 1,
                                                            before[1] + 1)
    assert torch.isfinite(lu.grad).all() and lu.grad.abs().max() > 0
    # impl="mxu" launches the ratio-form scan K7 once each way
    lu.grad = None
    before = scan_mxu.LAUNCHES, scan_mxu.BWD_LAUNCHES, scan_core.LAUNCHES
    y, last = selective_scan(lu, delta, A, B, C, return_last_state=True,
                             impl="mxu")
    (y.sum() + last.square().sum()).backward()
    assert (scan_mxu.LAUNCHES, scan_mxu.BWD_LAUNCHES,
            scan_core.LAUNCHES) == (before[0] + 1, before[1] + 1, before[2])
    assert torch.isfinite(lu.grad).all() and lu.grad.abs().max() > 0


def test_templates_reject_n8_and_k6_rejects_n_over_256(cuda):
    """The templates take N = 16 only: a direct call with N = 8 raises; K6
    (``scan_core``) runs other N as groups of 16 states (below) up to
    JAX's 256, and raises above it."""
    u, delta, A, B, C = _core_inputs(11, 1, 64, 32, cuda, N_=8)
    with pytest.raises(ValueError, match="N=16"):
        scan_dir._launch(u, delta, None, None, A, B, C, A[:, 0], A[:, 0],
                         reverse=False, gate=False, chunk_size=64,
                         return_states=False, softplus=False)
    u, delta, A, B, C = _core_inputs(11, 1, 64, 32, cuda, N_=272)
    with pytest.raises(ValueError, match="256"):
        scan_core.selective_scan_kernel(u, delta, A, B, C)


@pytest.mark.parametrize("N_", [4, 64, 20])
def test_scan_core_state_groups_match_plain(cuda, N_):
    """K6 at N != 16: ceil(N / 16) launches each way, forward (y, chunk
    states) and backward (du, ddelta, dA, dB, dC with a nonzero gradient of
    the last state) against the plain version."""
    R, L, D, T = 2, 300, 64, 128
    u, delta, A, B, C = _core_inputs(13, R, L, D, cuda, N_=N_)
    y, st = scan_core._launch(u, delta, A, B, C, T)
    y_p, st_p = scan_core.selective_scan_core_ref(u, delta, A, B, C, T,
                                                  return_states=True)
    _close(y, y_p, F32)
    _close(st, st_p, F32)
    dy = torch.randn(R, L, D, device=cuda)
    dlast = torch.randn(R, D, N_, device=cuda)
    leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
    before = scan_core.LAUNCHES, scan_core.BWD_LAUNCHES
    yk, last = scan_core.selective_scan_kernel(*leaves,
                                               return_last_state=True)
    torch.autograd.backward((yk, last), (dy, dlast))
    groups = -(-N_ // 16)
    assert (scan_core.LAUNCHES - before[0],
            scan_core.BWD_LAUNCHES - before[1]) == (groups, groups)
    want = scan_core.selective_scan_core_bwd_ref(u, delta, A, B, C, dy,
                                                 dlast, T)
    for name, leaf, w in zip(("du", "ddelta", "dA", "dB", "dC"), leaves,
                             want):
        _grad_close(f"{name} N={N_}", leaf.grad, w, F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slice_kernel_matches_plain(cuda, dtype):
    """K5 forward (output, chunk states) and backward (all eight gradients
    through the autograd Function) against the plain versions: ragged
    chunks, masked channels, shared and per-row parameters."""
    for (R, L, D, S, T), per_row in itertools.product(
            [(2, 512, 96, 8, 128), (1, 300, 50, 6, 128),
             (1, 192, 136, 4, 32)], [False, True]):
        u, dt, z, _, B, C, A, Dv, bias = _inputs(
            14, R, L, D, dtype, per_row, True, cuda)
        args = (u, dt, z, A, B, C, Dv, bias)
        before = scan_dir.SLICE_LAUNCHES, scan_dir.LAUNCHES
        got, st = scan_dir.mamba_scan_fused_slice(
            *args, nslices=S, chunk_size=T, return_states=True)
        assert (scan_dir.SLICE_LAUNCHES - before[0],
                scan_dir.LAUNCHES - before[1]) == (1, 0)
        want, st_ref = scan_dir.mamba_scan_fused_slice_ref(
            *args, nslices=S, chunk_size=T, return_states=True)
        _close(got, want, TOL[dtype])
        _close(st, st_ref, F32)
        dout = torch.randn(R, L, D, device=cuda).to(dtype)
        leaves = [t.detach().requires_grad_() for t in args]
        scan_dir.mamba_scan_fused_slice(*leaves, nslices=S,
                                        chunk_size=T).backward(dout)
        want = scan_dir.mamba_scan_fused_slice_bwd_ref(
            *args, dout, nslices=S, chunk_size=T)
        want = [w for w in want if w is not None]
        for name, leaf, w in zip(("du", "ddt", "dz", "dA", "dB", "dC", "dD",
                                  "dbias"), leaves, want):
            _grad_close(f"{name} {(R, L, D, S)}", leaf.grad, w, TOL[dtype])


def _proj_inputs(seed, b, L, D, rank, dtype, device):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32)).to(device)
    xc, acc = f(b, L, D).to(dtype), f(b, L, D).to(dtype)
    z = f(b, L, 2 * D)[..., D:].to(dtype)
    return (xc, f(D, rank + 2 * N, sc=0.1).to(dtype), f(rank, D, sc=0.3),
            f(D, sc=0.5), -torch.exp(f(D, N)), f(D), z, acc)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_kernel_matches_plain(cuda, reverse, dtype):
    """K8 forward (output, chunk states) and backward (all eight gradients
    through ``_ProjScan``) against the plain versions, in every z/acc flag
    set, ragged L, masked channels, several dt_ranks."""
    for (b, L, D, rank, T), (zk, acck) in itertools.product(
            [(2, 300, 96, 3, 128), (1, 200, 50, 4, 64),
             (1, 96, 128, 8, 32)],
            [(True, True), (False, True), (False, False), (True, False)]):
        xc, wp, dtp, bias, A, Dv, z, acc = _proj_inputs(
            15, b, L, D, rank, dtype, cuda)
        kw = dict(z=z if zk else None, acc=acc if acck else None,
                  reverse=reverse, chunk_size=T)
        args = (xc, wp, dtp, bias, A, Dv)
        before = scan_proj.LAUNCHES, scan_proj.BWD_LAUNCHES
        got, st = scan_proj.mamba_scan_proj(*args, return_states=True, **kw)
        want, st_ref = scan_proj.mamba_scan_proj_ref(
            *args, return_states=True, **kw)
        _close(got, want, TOL[dtype])
        _close(st, st_ref, F32)
        dout = torch.randn(b, L, D, device=cuda).to(dtype)
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in args + (kw["z"], kw["acc"])]
        scan_proj.mamba_scan_proj(
            *leaves[:6], z=leaves[6], acc=leaves[7], reverse=reverse,
            chunk_size=T).backward(dout)
        assert (scan_proj.LAUNCHES - before[0],
                scan_proj.BWD_LAUNCHES - before[1]) == (2, 1)
        want = scan_proj.mamba_scan_proj_bwd_ref(*args, dout, **kw)
        for name, leaf, w in zip(("dxc", "dx_proj", "ddt_proj", "ddt_bias",
                                  "dA", "dD", "dz", "dacc"), leaves, want):
            if leaf is None:
                assert w is None
                continue
            assert leaf.grad.dtype == leaf.dtype
            _grad_close(f"{name} {(b, L, D, rank)} z={zk} acc={acck}",
                        leaf.grad, w, TOL[dtype])


@pytest.mark.parametrize("scan_impl,slice_kernel", [("proj", False),
                                                    ("dir", True)])
def test_mamba_v3_composition_kernels_match_plain(cuda, scan_impl,
                                                  slice_kernel):
    """A MambaV3 of each new composition on the card (K8 x 3, or K1 x 2 +
    K5) against the same module on the CPU (the plain versions): output
    and every parameter gradient."""
    h = np.random.default_rng(16).standard_normal((2, 512, 48)).astype(
        np.float32)
    grads, outs = [], []
    for device in (cuda, torch.device("cpu")):
        m = MambaV3(d_model=48, nslices=8, scan_impl=scan_impl,
                    slice_kernel=slice_kernel,
                    generator=torch.Generator().manual_seed(0),
                    device=device)
        out = m(torch.from_numpy(h).to(device))
        out.square().mean().backward()
        outs.append(out.detach().cpu())
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
    _close(outs[0], outs[1], F32)
    for k, w in grads[1].items():
        _grad_close(k, grads[0][k], w, F32)


def test_tiny_lm_generate_kernel_path_matches_plain(cuda):
    """Greedy tokens of a tiny LM on the card: K6 prefill (one launch per
    layer, no scan launch while decoding) equals the plain scans."""
    model = MambaLMHeadModel(64, 32, 3, rms_norm=True,
                             generator=torch.Generator().manual_seed(0),
                             device=cuda)
    ids = torch.from_numpy(np.random.default_rng(12).integers(
        0, 64, (2, 300))).to(cuda)
    before = scan_core.LAUNCHES
    got = model.generate(ids, 8)
    assert scan_core.LAUNCHES == before + 3
    for blk in model.backbone.layers:
        blk.mixer.scan_impl = "chunked"
    want = model.generate(ids, 8)
    assert scan_core.LAUNCHES == before + 3
    assert torch.equal(got, want)


def _mxu_inputs(seed, R, L, D, N_, kind, device):
    """K7's float32 operands as ``_core_inputs``; ``kind`` "benign" (A
    scaled down: every unit in the ratio form), "model", "tripped" (delta
    + 40: every unit in the step form) or "mixed" (delta + 2 on every
    third chunk of 128 steps and every other channel: there the units with
    larger |A| trip)."""
    u, delta, A, B, C = _core_inputs(seed, R, L, D, device, N_=N_)
    if kind == "benign":
        A = A * 0.05
    elif kind == "tripped":
        delta = delta + 40.0
    elif kind == "mixed":
        t = (torch.arange(L, device=device) // 128) % 3 == 1
        delta = delta + 2.0 * (t[:, None] & (torch.arange(
            D, device=device) % 2 == 0))
    return u, delta, A, B, C


@pytest.mark.parametrize("R,L,D,N_,kind,guarded", [
    (2, 256, 96, 16, "model", True), (1, 200, 50, 16, "mixed", True),
    (2, 300, 136, 4, "model", True), (1, 37, 40, 64, "benign", True),
    (1, 520, 32, 64, "mixed", True), (1, 256, 40, 16, "tripped", True),
    (1, 300, 64, 16, "benign", False)])
def test_mxu_kernel_matches_plain(cuda, R, L, D, N_, kind, guarded):
    """K7 forward (y, chunk states, last state) and backward (du, ddelta,
    dA, dB, dC with a nonzero gradient of the last state) against the plain
    versions: ragged L (200, 37, 300, 520), one chunk and many, N = 4 / 16 /
    64 (groups of 16 states), guard-tripped and mixed inputs, and the
    unguarded ratio form."""
    u, delta, A, B, C = _mxu_inputs(15, R, L, D, N_, kind, cuda)
    T, S = scan_mxu._geometry(L)
    y, st = scan_mxu._launch(u, delta, A, B, C, T, S, guarded)
    y_p, st_p = scan_mxu.selective_scan_mxu_core_ref(
        u, delta, A, B, C, guarded=guarded, return_states=True)
    _close(y, y_p, F32)
    _close(st, st_p, F32)
    dy = torch.randn(R, L, D, device=cuda)
    dlast = torch.randn(R, D, N_, device=cuda)
    leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
    before = scan_mxu.LAUNCHES, scan_mxu.BWD_LAUNCHES
    yk, last = scan_mxu._MxuCore.apply(T, S, guarded, *leaves)
    _close(last, scan_core._last_state(st_p), F32)
    torch.autograd.backward((yk, last), (dy, dlast))
    groups = -(-N_ // 16)
    assert (scan_mxu.LAUNCHES - before[0],
            scan_mxu.BWD_LAUNCHES - before[1]) == (groups, groups)
    want = scan_mxu.selective_scan_mxu_core_bwd_ref(
        u, delta, A, B, C, dy, dlast, guarded=guarded)
    for name, leaf, w in zip(("du", "ddelta", "dA", "dB", "dC"), leaves,
                             want):
        _grad_close(f"{name} {(R, L, D, N_, kind)}", leaf.grad, w, F32)


@pytest.mark.parametrize("kind", ["benign", "tripped"])
def test_mxu_tally_counts_units(cuda, kind):
    """All-benign inputs send every (row, channel, state, sub-block) unit
    to the ratio form, all-tripped ones every unit to the step form; the
    forward and the backward each count every unit once, and the plain
    version counts the same."""
    R, L, D = 2, 300, 64
    u, delta, A, B, C = _mxu_inputs(16, R, L, D, 16, kind, cuda)
    units = R * D * 16 * -(-L // 16)
    leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
    with scan_mxu.tally() as t:
        y, last = scan_mxu.selective_scan_mxu(*leaves,
                                              return_last_state=True)
        torch.autograd.backward((y, last), (torch.ones_like(y),
                                            torch.ones_like(last)))
    want = (2 * units, 0) if kind == "benign" else (0, 2 * units)
    assert (t.ratio, t.step) == want
    with scan_mxu.tally() as tp:
        scan_mxu.selective_scan_mxu_core_ref(u.cpu(), delta.cpu(), A.cpu(),
                                             B.cpu(), C.cpu())
    assert (tp.ratio, tp.step) == (want[0] // 2, want[1] // 2)


def test_mxu_never_syncs_the_host(cuda):
    """The per-unit guard is decided on the card: a K7 forward and
    backward on mixed inputs run under ``set_sync_debug_mode("error")``."""
    u, delta, A, B, C = _mxu_inputs(17, 2, 512, 128, 16, "mixed", cuda)
    leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
    dy, dl = torch.randn_like(u), torch.randn(2, 128, 16, device=cuda)
    scan_mxu._lib(), scan_mxu._bwd_lib()   # build outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, last = scan_mxu.selective_scan_mxu(*leaves, delta_softplus=True,
                                              return_last_state=True)
        torch.autograd.backward((y, last), (dy, dl))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(t.grad).all() for t in leaves)


def test_mxu_dispatch_sends_grouped_bc_to_chunked(cuda):
    """``impl="mxu"`` with grouped (batch, L, G, N) B/C takes the chunked
    core, as in JAX, instead of raising or launching K7."""
    u, delta, A, _, _ = _core_inputs(18, 1, 64, 32, cuda, N_=4)
    B = torch.randn(1, 64, 2, 4, device=cuda)
    C = torch.randn(1, 64, 2, 4, device=cuda)
    before = scan_mxu.LAUNCHES
    y = selective_scan(u, delta, A, B, C, impl="mxu")
    assert scan_mxu.LAUNCHES == before
    want = selective_scan(u, delta, A, B, C, impl="chunked")
    assert torch.equal(y, want)
