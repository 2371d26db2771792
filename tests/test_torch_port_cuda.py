"""The Hopper kernels against their plain PyTorch versions, on the card
(K1-K4 through ``scan_dir`` / ``scan_fused``, K5 through
``scan_dir.mamba_scan_fused_slice``, K6 through ``scan_core``, K7 through
``scan_mxu``, K8 through ``scan_proj``; at d_state 4 and 32 through the
wrappers' groups of 16 states; the 3x3x3 conv K9 and its weight gradient
through ``conv3d``; the scan probes K10 and K11 through the benchmark
twins ``benchmarks.bench_scan_lb`` and ``benchmarks.bench_scan_flat``).

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

from segmamba_tpu_torch.benchmarks import bench_scan_flat, bench_scan_lb
from segmamba_tpu_torch.models import MambaLMHeadModel, SegMamba
from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.ops import (
    conv3d,
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


def _inputs(seed, R, L, D, dtype, per_row, strided, device, N=N):
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
    with pytest.raises(ValueError, match="N=16"):   # one launch: 16 states
        scan_dir._launch(u, dt, z, None, A[:, :8], B[..., :8], C[..., :8],
                         Dv, bias, reverse=False, gate=True, chunk_size=128,
                         return_states=False)
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


# The forward template is one single-pass kernel with a decoupled
# look-back over chunk tiles; these cases stress the look-back and the
# tile edges. (R, L, D, chunk_size, per-row parameters)
SINGLE_PASS_CASES = [
    (2, 65536, 96, 128, False),   # 512 tiles a row: long look-back chains
    (1, 128, 96, 128, False),     # nc = 1: no look-back
    (2, 256, 96, 128, True),      # nc = 2, per-row A, D and bias
    (1, 1000, 50, 128, False),    # ragged L and ragged D
    (2, 333, 96, 128, True),      # ragged L, per row
    (1, 8192, 192, 32, False),    # 256 tiles of 32 steps, two channel blocks
]


@pytest.mark.parametrize("R,L,D,T,per_row", SINGLE_PASS_CASES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_pass_forward_matches_plain(cuda, R, L, D, T, per_row,
                                           reverse, dtype):
    """Output and chunk exit states (R, ceil(L / T), N, D) in scan order,
    with acc and the gate, forward and reverse, against the plain
    version."""
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        11, R, L, D, dtype, per_row, True, cuda)
    kw = dict(acc=acc, gate=True, reverse=reverse, chunk_size=T,
              return_states=True)
    args = (u, dt, z, A, B, C, Dv, bias)
    got, st = scan_dir.mamba_scan_fused_dir(*args, **kw)
    want, st_ref = scan_dir.mamba_scan_fused_dir_ref(*args, **kw)
    assert st.shape == (R, -(-L // T), N, D)
    _close(got, want, TOL[dtype])
    _close(st, st_ref, F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_many_chunks_of_32_matches_plain(cuda, dtype):
    """K2 at chunk_size 32 over 2,048 tiles a row."""
    u, dt, z, _, B, C, A, Dv, bias = _inputs(15, 2, 65536, 96, dtype, True,
                                             True, cuda)
    args = (u, dt, z, A, B, C, Dv, bias)
    got, st = scan_fused.mamba_scan_fused(*args, chunk_size=32,
                                          return_states=True)
    want, st_ref = scan_fused.mamba_scan_fused_ref(*args, chunk_size=32,
                                                   return_states=True)
    _close(got, want, TOL[dtype])
    _close(st, st_ref, F32)


def test_single_pass_forward_is_deterministic(cuda):
    """Repeated launches on the same inputs give the same bits (K1 both
    ways, K2, K5, K6): wherever a tile's look-back stops, it folds the
    chunk carries in chunk order from chunk 0's state."""
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        12, 2, 65536, 96, torch.bfloat16, False, True, cuda)
    args = (u, dt, z, A, B, C, Dv, bias)
    uf, deltaf = u.float(), torch.nn.functional.softplus(dt.float())
    calls = {
        "K1 reverse": lambda: scan_dir.mamba_scan_fused_dir(
            *args, acc=acc, reverse=True, return_states=True),
        "K1 forward": lambda: scan_dir.mamba_scan_fused_dir(
            *args, acc=acc, return_states=True),
        "K2": lambda: scan_fused.mamba_scan_fused(*args, return_states=True),
        "K5": lambda: scan_dir.mamba_scan_fused_slice(
            *args, nslices=64, return_states=True),
        "K6": lambda: scan_core._launch(uf, deltaf, A, B.float(), C.float(),
                                        128),
    }
    for name, call in calls.items():
        first = call()
        for _ in range(3):
            again = call()
            assert all(torch.equal(a, b) for a, b in zip(first, again)), name


def test_forward_scan_is_one_kernel(cuda):
    """One forward call runs one kernel on the card, beside the zero fill
    of its flags: no carry pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        13, 1, 8192, 96, torch.bfloat16, False, True, cuda)
    call = lambda: scan_dir.mamba_scan_fused_dir(
        u, dt, z, A, B, C, Dv, bias, acc=acc, reverse=True)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and e.self_device_time_total > 0]
    kernels = [n for n in names if "scan_fwd_kernel" in n]
    others = [n for n in names if "scan_fwd_kernel" not in n]
    assert len(kernels) == 1 and sum(
        e.count for e in prof.key_averages() if e.key == kernels[0]) == 1
    assert all("fill" in n.lower() or "memset" in n.lower()
               for n in others), others


def test_single_pass_states_feed_the_backward(cuda):
    """The backward rebuilds x from the forward's saved states: gradients
    through ``_GatedScan`` over 32 tiles match the plain backward."""
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        16, 2, 4096, 96, torch.float32, True, True, cuda)
    dout = torch.randn(2, 4096, 96, device=cuda)
    leaves = [t.detach().requires_grad_()
              for t in (u, dt, z, acc, A, B, C, Dv, bias)]
    lu, ldt, lz, la, lA, lB, lC, lD, lb = leaves
    scan_dir.mamba_scan_fused_dir(lu, ldt, lz, lA, lB, lC, lD, lb, acc=la,
                                  reverse=True).backward(dout)
    want = scan_dir.mamba_scan_fused_dir_bwd_ref(
        u, dt, z, A, B, C, Dv, bias, dout, acc=acc, reverse=True)
    for name, leaf, w in zip(GRADS, leaves, want):
        _grad_close(name, leaf.grad, w, F32)


# The single-pass backward (one kernel per call and group of 16 states):
# long walks, ragged L and D, per-row parameters at R = 3. Small decays
# (|A| ~ 0.02, delta ~ 0.05) carry the adjoint over many chunks, so every
# chunk's entry depends on the look-back's fold.
SINGLE_PASS_BWD_CASES = [   # R, L, D, per_row, reverse, gate, acc
    (1, 300 * 128 + 17, 48, False, True, True, True),   # 301 chunks
    (1, 300 * 128 + 17, 48, False, False, False, False),
    (2, 1000, 52, True, False, True, True),              # D % 48 != 0
    (2, 1000, 100, False, True, False, False),
    (2, 777, 200, True, True, True, False),
    (3, 640, 96, True, False, True, True),               # R = 3
    (3, 640, 96, False, True, False, False),
]


def _slow_decay(A, bias):
    return 0.02 * A, bias - 3.0


@pytest.mark.parametrize("R,L,D,per_row,reverse,gate,has_acc",
                         SINGLE_PASS_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_pass_backward_matches_plain(cuda, R, L, D, per_row, reverse,
                                            gate, has_acc, dtype):
    """Every gradient of the single-pass backward against the plain one,
    through the autograd Function, one backward launch a call."""
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        30 + L + D, R, L, D, dtype, per_row, True, cuda)
    A, bias = _slow_decay(A, bias)
    dout = torch.randn(R, L, D, device=cuda).to(dtype)
    zz, a = (z if gate else None), (acc if has_acc else None)
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (u, dt, zz, a, A, B, C, Dv, bias)]
    lu, ldt, lz, la, lA, lB, lC, lD, lb = leaves
    before = scan_dir.BWD_LAUNCHES
    scan_dir.mamba_scan_fused_dir(lu, ldt, lz, lA, lB, lC, lD, lb, acc=la,
                                  gate=gate, reverse=reverse).backward(dout)
    assert scan_dir.BWD_LAUNCHES == before + 1
    want = scan_dir.mamba_scan_fused_dir_bwd_ref(
        u, dt, zz, A, B, C, Dv, bias, dout, acc=a, gate=gate,
        reverse=reverse)
    for name, leaf, w in zip(GRADS, leaves, want):
        if leaf is not None:
            _grad_close(f"{name} {(R, L, D)}", leaf.grad, w, TOL[dtype])


@pytest.mark.parametrize("nslices,L", [(2, 2 * 1500), (3, 3 * 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_pass_slice_backward_matches_plain(cuda, nslices, L, dtype):
    """K5's backward (SLICE) at S = 2 and 3 against the plain one."""
    R, D = 2, 96
    u, dt, z, _, B, C, A, Dv, bias = _inputs(40 + nslices, R, L, D, dtype,
                                             False, True, cuda)
    A, bias = _slow_decay(A, bias)
    dout = torch.randn(R, L, D, device=cuda).to(dtype)
    leaves = [t.detach().requires_grad_()
              for t in (u, dt, z, A, B, C, Dv, bias)]
    before = scan_dir.SLICE_BWD_LAUNCHES
    scan_dir.mamba_scan_fused_slice(*leaves, nslices=nslices).backward(dout)
    assert scan_dir.SLICE_BWD_LAUNCHES == before + 1
    want = scan_dir.mamba_scan_fused_slice_bwd_ref(
        u, dt, z, A, B, C, Dv, bias, dout, nslices=nslices)
    names = [n for n in GRADS if n != "dacc"]
    for name, leaf, w in zip(names, leaves,
                             [w for n, w in zip(GRADS, want) if n != "dacc"]):
        _grad_close(f"{name} S={nslices}", leaf.grad, w, TOL[dtype])


@pytest.mark.parametrize("L", [100, 40 * 128 + 3])
def test_single_pass_core_backward_seeds_dlast(cuda, L):
    """K6's backward seeded by the gradient of the last state, with one
    chunk (the seed is the only entry) and many (it enters the fold)."""
    R, D, T = 2, 80, 128
    u, delta, A, B, C = _core_inputs(50, R, L, D, cuda)
    A = 0.05 * A
    dy = torch.randn(R, L, D, device=cuda)
    dlast = torch.randn(R, D, N, device=cuda)
    leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
    yk, last = scan_core._ScanCore.apply(T, *leaves)
    torch.autograd.backward((yk, last), (dy, dlast))
    want = scan_core.selective_scan_core_bwd_ref(u, delta, A, B, C, dy,
                                                 dlast, T)
    for name, leaf, w in zip(("du", "ddelta", "dA", "dB", "dC"), leaves,
                             want):
        _grad_close(f"{name} L={L}", leaf.grad, w, F32)


def test_single_pass_backward_n32_groups(cuda):
    """N = 32 through the wrapper's two groups (the second group's adjoint
    seeded by the chain's dacc) over 40 chunks."""
    R, L, D, N_ = 2, 40 * 128 + 9, 96, 32
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        60, R, L, D, torch.float32, False, True, cuda, N=N_)
    A, bias = _slow_decay(A, bias)
    dout = torch.randn(R, L, D, device=cuda)
    leaves = [t.detach().requires_grad_()
              for t in (u, dt, z, acc, A, B, C, Dv, bias)]
    lu, ldt, lz, la, lA, lB, lC, lD, lb = leaves
    before = scan_dir.BWD_LAUNCHES
    scan_dir.mamba_scan_fused_dir(lu, ldt, lz, lA, lB, lC, lD, lb, acc=la,
                                  reverse=True).backward(dout)
    assert scan_dir.BWD_LAUNCHES == before + 2
    want = scan_dir.mamba_scan_fused_dir_bwd_ref(
        u, dt, z, A, B, C, Dv, bias, dout, acc=acc, reverse=True)
    for name, leaf, w in zip(GRADS, leaves, want):
        _grad_close(f"{name} N=32", leaf.grad, w, F32)


def test_single_pass_backward_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits for every
    gradient (K3 both flag sets, K4, K5, K6): wherever a tile's look-back
    stops, it folds the same records in the same order from the seed."""
    R, L, D = 2, 65536, 96
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        70, R, L, D, torch.bfloat16, False, True, cuda)
    A, bias = _slow_decay(A, bias)
    dout = torch.randn(R, L, D, device=cuda).to(torch.bfloat16)
    T = scan_dir.DEF_CHUNK
    calls = {}
    for name, kw in (("K3 reverse", dict(reverse=True, gate=False)),
                     ("K3 gate acc", dict(gate=True, acc=acc)),
                     ("K4", dict(gate=True)), ("K5", dict(nslices=64))):
        kw = dict(kw)
        ac, gate = kw.pop("acc", None), kw.pop("gate", True)
        zz = z if gate else None
        fwd = dict(reverse=kw.get("reverse", False), gate=gate,
                   chunk_size=T, nslices=kw.get("nslices", 0))
        _, st = scan_dir._launch(u, dt, zz, ac, A, B, C, Dv, bias,
                                 return_states=True, **fwd)
        calls[name] = (lambda zz=zz, ac=ac, st=st, fwd=fwd:
                       scan_dir._launch_bwd(u, dt, zz, ac, A, B, C, Dv,
                                            bias, dout, st, **fwd))
    uf, deltaf = u.float(), torch.nn.functional.softplus(dt.float() - 3.0)
    _, st6 = scan_core._launch(uf, deltaf, A, B.float(), C.float(), T)
    dlast = torch.randn(R, D, N, device=cuda)
    calls["K6"] = lambda: scan_core._launch_bwd(
        uf, deltaf, A, B.float(), C.float(), dout.float(), dlast, st6, T)
    for name, call in calls.items():
        first = call()
        again = call()
        assert all(torch.equal(a, b) for a, b in zip(first, again)
                   if a is not None), name


def test_backward_scan_is_one_kernel(cuda):
    """One backward call runs one scan kernel on the card, beside the zero
    fill of its flags and the wrapper's sums of the partials: no chunk or
    carry pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    u, dt, z, acc, B, C, A, Dv, bias = _inputs(
        71, 1, 8192, 96, torch.bfloat16, False, True, cuda)
    dout = torch.randn(1, 8192, 96, device=cuda).to(torch.bfloat16)
    _, st = scan_dir._launch(u, dt, z, acc, A, B, C, Dv, bias, reverse=True,
                             gate=True, chunk_size=scan_dir.DEF_CHUNK,
                             return_states=True)
    call = lambda: scan_dir._launch_bwd(
        u, dt, z, acc, A, B, C, Dv, bias, dout, st, reverse=True, gate=True,
        chunk_size=scan_dir.DEF_CHUNK)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.self_device_time_total > 0]
    scans = [e for e in events if "scan_bwd_kernel" in e.key]
    others = [e.key for e in events if "scan_bwd_kernel" not in e.key]
    assert len(scans) == 1 and scans[0].count == 1, [e.key for e in events]
    assert not any("bwd" in k or "scan" in k for k in others), others


def _param_grads(model, x, labels):
    model.zero_grad(set_to_none=True)
    logits = model(x)
    torch.nn.functional.cross_entropy(logits, labels).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


# Conv biases that feed an instance norm (every GSC conv: ``cir`` is
# relu(instance_norm(conv(h)))): the norm subtracts each channel's mean, so
# the gradient of such a bias is zero up to rounding, and a bound relative
# to its own max |grad| would hold rounding noise to 1e-2 of itself. They
# are held by the relative-L2 check over all gradients instead, and each
# must stay at rounding level (below 1e-3 of the model's largest |grad|).
IN_FED_BIASES = tuple(f"vit.gscs.{i}.{name}.bias" for i in range(4)
                      for name in ("proj", "proj2", "proj3", "proj4"))


def test_tiny_segmamba_grads_kernel_path_matches_plain(cuda):
    """Every parameter gradient of the tiny model (f32): the kernel path
    against the same model on the plain scans: all together within 1e-3
    relative L2 (two plain compositions of the same math differ by ~5e-5),
    and each parameter but ``IN_FED_BIASES`` within rtol 2e-3 / atol 1e-2
    of its own largest |gradient|; every out-of-bound parameter is named
    in the failure with its error and the disagreement of two plain
    compositions of the same math (dir2 and per-direction "chunked") on
    it."""
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
    assert set(IN_FED_BIASES) <= set(want)
    bad = {}
    for k, w in want.items():
        if k in IN_FED_BIASES:
            assert max(float(got[k].abs().max()),
                       float(w.abs().max())) <= 1e-3 * top, k
            continue
        err = (got[k] - w).abs()
        lim = 1e-2 * float(w.abs().max()) + 2e-3 * w.abs()
        if (err > lim).any():
            bad[k] = float(err.max()) / max(float(w.abs().max()), 1e-30)
    if bad:   # two plain compositions' disagreement on the same ones
        for layer in model.modules():
            if isinstance(layer, MambaV3):
                layer.scan_impl = "chunked"     # per direction, plain
        twin = _param_grads(model, x, labels)
        rel = {k: float((twin[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in bad}
        raise AssertionError("; ".join(
            f"{k}: max err {v:.3e} of its max |grad| (plain dir2 vs plain "
            f"per-direction: {rel[k]:.3e})" for k, v in bad.items()))
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
    set, ragged L, masked channels, several dt_ranks; a call of 71 chunks
    (look-back walks cross lagging chunks) and the widest tile, E = 128 at
    the default chunk of 128 (one backward block of 512 threads), each
    with exactly one forward and one backward launch."""
    for (b, L, D, rank, T), (zk, acck) in itertools.product(
            [(2, 300, 96, 3, 128), (1, 200, 50, 4, 64),
             (1, 96, 128, 8, 32), (2, 70 * 64 + 9, 96, 3, 64),
             (1, 1000, 128, 4, 128)],
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


@pytest.mark.parametrize("reverse", [False, True])
def test_proj_bfloat16_io_with_float32_x_proj(cuda, reverse):
    """bfloat16 xc with a float32 x_proj: the projections stay float32
    FMAs on the CUDA cores (the tensor cores take only bf16 x bf16);
    forward and the eight gradients against the plain versions."""
    b, L, D, rank, T = 2, 300, 96, 3, 64
    xc, wp, dtp, bias, A, Dv, z, acc = _proj_inputs(
        33, b, L, D, rank, torch.bfloat16, cuda)
    wp = wp.float()
    kw = dict(z=z, acc=acc, reverse=reverse, chunk_size=T)
    args = (xc, wp, dtp, bias, A, Dv)
    got, st = scan_proj.mamba_scan_proj(*args, return_states=True, **kw)
    want, st_ref = scan_proj.mamba_scan_proj_ref(*args, return_states=True,
                                                 **kw)
    _close(got, want, TOL[torch.bfloat16])
    _close(st, st_ref, F32)
    dout = torch.randn(b, L, D, device=cuda).to(torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in args + (z, acc)]
    scan_proj.mamba_scan_proj(*leaves[:6], z=leaves[6], acc=leaves[7],
                              reverse=reverse, chunk_size=T).backward(dout)
    want = scan_proj.mamba_scan_proj_bwd_ref(*args, dout, **kw)
    for name, leaf, w in zip(("dxc", "dx_proj", "ddt_proj", "ddt_bias",
                              "dA", "dD", "dz", "dacc"), leaves, want):
        _grad_close(f"{name} reverse={reverse}", leaf.grad, w,
                    TOL[torch.bfloat16])


def test_proj_kernels_give_the_same_bits_twice(cuda):
    """Two K8 calls on the same inputs give the same bits, forward (output
    and chunk states) and all eight gradients, in the chain's three flag
    sets and both dtypes: the look-backs fold in one order wherever a walk
    stops, and the weight partials are added by the wrapper in one
    order."""
    b, L, D, rank = 2, 40 * 128 + 3, 96, 3
    for dtype, (zk, acck, reverse) in itertools.product(
            (torch.float32, torch.bfloat16),
            ((False, False, False), (False, True, True),
             (True, True, False))):
        xc, wp, dtp, bias, A, Dv, z, acc = _proj_inputs(
            31, b, L, D, rank, dtype, cuda)
        ins = (xc, wp, dtp, bias, A, Dv, z if zk else None,
               acc if acck else None)
        dout = torch.randn(b, L, D, device=cuda).to(dtype)

        def run():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in ins]
            out, st = scan_proj.mamba_scan_proj(
                *leaves[:6], z=leaves[6], acc=leaves[7], reverse=reverse,
                return_states=True)
            out.backward(dout)
            return [out, st] + [t.grad for t in leaves if t is not None]

        first, again = run(), run()
        assert len(first) == 2 + 6 + zk + acck
        for k, (x, y) in enumerate(zip(first, again)):
            assert torch.equal(x, y), (dtype, zk, acck, k)


_PROJ_ONE_KERNEL_CHILD = """
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from segmamba_tpu_torch.ops import scan_proj
g = torch.Generator(device="cuda").manual_seed(32)
b, L, D, rank, N = 1, 8192, 96, 3, 16
rn = lambda *s, sc=1.0: sc * torch.randn(*s, generator=g, device="cuda")
bf = torch.bfloat16
xc, z, acc, dout = (rn(b, L, D).to(bf) for _ in range(4))
args = (xc, rn(D, rank + 2 * N, sc=0.1).to(bf), rn(rank, D, sc=0.3),
        rn(D, sc=0.5), -torch.exp(rn(D, N)), rn(D), z, acc)
kw = dict(reverse=False, chunk_size=scan_proj.DEF_CHUNK)
st = scan_proj._launch(*args, return_states=True, **kw)[1]
fwd = lambda: scan_proj._launch(*args, return_states=False, **kw)
bwd = lambda: scan_proj._launch_bwd(*args, dout, st, **kw)
fwd(), bwd()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    fwd()
    bwd()
    torch.cuda.synchronize()
print(json.dumps({e.key: e.count for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and e.self_device_time_total > 0}))
"""


def test_proj_call_is_one_kernel_each_way(cuda):
    """A K8 forward call runs one scan kernel (``proj_fwd_kernel``) and a
    backward call one (``proj_bwd_kernel``), beside the zero fill of the
    flags and the wrapper's sums of the partials: no carry pass. Profiled
    in a fresh process (a later profiler session in a long one can come
    back without the card's kernels), taken again once if it comes back
    empty."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _PROJ_ONE_KERNEL_CHILD],
                              capture_output=True, text=True, timeout=600,
                              cwd=root)
        assert proc.returncode == 0, proc.stderr[-3000:]
        counts = json.loads(proc.stdout.strip().splitlines()[-1])
        if counts:
            break
    for name in ("proj_fwd_kernel", "proj_bwd_kernel"):
        scans = [k for k in counts if name in k]
        assert len(scans) == 1 and counts[scans[0]] == 1, counts
    others = [k for k in counts if "proj_" not in k]
    assert not any("proj" in k or "scan" in k for k in others), others


def test_proj_smem_mirror_matches_the_kernels(cuda):
    """``scan_proj._smem_bytes``, the dispatch's mirror of K8's shared
    memory, gives the bytes of the libraries' ``proj_scan_fwd_smem`` /
    ``proj_scan_bwd_smem`` over d_inner, dt_rank, T and both I/O dtypes."""
    lib, blib = scan_proj._lib(), scan_proj._bwd_lib()
    for E, rank, T, bf in itertools.product(
            (1, 24, 50, 96, 128), (1, 3, 6, 7, 16), (1, 32, 100, 128, 256),
            (0, 1)):
        want = (lib.proj_scan_fwd_smem(E, rank, T, bf),
                blib.proj_scan_bwd_smem(E, rank, T, bf))
        assert scan_proj._smem_bytes(E, rank, T, 2 if bf else 4) == want, (
            E, rank, T, bf)


@pytest.mark.parametrize("E,rank,T,bigger", [
    (128, 6, 128, (128, 7, 128)), (64, 16, 256, (96, 1, 256))])
def test_proj_largest_tiles_run_and_larger_raise(cuda, E, rank, T, bigger):
    """The largest tiles ``proj_scan_supported`` takes run: forward and the
    eight gradients against the plain versions (float32, gate and acc).
    The next larger raises a ValueError before any launch, and a MambaV3
    layer of that size runs the directional scan on the card, forward and
    backward."""
    b, L = 1, 3 * T + 5
    xc, wp, dtp, bias, A, Dv, z, acc = _proj_inputs(
        41, b, L, E, rank, torch.float32, cuda)
    args = (xc, wp, dtp, bias, A, Dv)
    kw = dict(z=z, acc=acc, reverse=False, chunk_size=T)
    got, st = scan_proj.mamba_scan_proj(*args, return_states=True, **kw)
    want, st_ref = scan_proj.mamba_scan_proj_ref(*args, return_states=True,
                                                 **kw)
    _close(got, want, F32)
    _close(st, st_ref, F32)
    dout = torch.randn(b, L, E, device=cuda)
    leaves = [t.detach().requires_grad_() for t in args + (z, acc)]
    scan_proj.mamba_scan_proj(*leaves[:6], z=leaves[6], acc=leaves[7],
                              chunk_size=T).backward(dout)
    want = scan_proj.mamba_scan_proj_bwd_ref(*args, dout, **kw)
    for name, leaf, w in zip(("dxc", "dx_proj", "ddt_proj", "ddt_bias",
                              "dA", "dD", "dz", "dacc"), leaves, want):
        _grad_close(f"{name} {(E, rank, T)}", leaf.grad, w, F32)

    E2, rank2, T2 = bigger
    big = _proj_inputs(42, b, 2 * T2, E2, rank2, torch.float32, cuda)
    before = scan_proj.LAUNCHES, scan_proj.BWD_LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        scan_proj.mamba_scan_proj(*big[:6], chunk_size=T2)
    assert (scan_proj.LAUNCHES, scan_proj.BWD_LAUNCHES) == before
    d_model = E2 if rank2 > 1 else E2 // 2
    m = MambaV3(d_model=d_model, expand=E2 // d_model, dt_rank=rank2,
                nslices=4, scan_impl="proj", scan_chunk=T2,
                generator=torch.Generator().manual_seed(0), device=cuda)
    assert m.composition(cuda) == "dir"
    h = torch.randn(1, 2 * T2, d_model, device=cuda, requires_grad=True)
    m(h).square().mean().backward()
    assert torch.isfinite(h.grad).all() and h.grad.abs().max() > 0
    assert (scan_proj.LAUNCHES, scan_proj.BWD_LAUNCHES) == before


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
    larger |A| trip) or "spiked" (delta + 40 on every third chunk of 128
    steps, every channel: the next chunk starts from a state ~40x larger
    that hardly decays)."""
    u, delta, A, B, C = _core_inputs(seed, R, L, D, device, N_=N_)
    if kind == "benign":
        A = A * 0.05
    elif kind == "tripped":
        delta = delta + 40.0
    elif kind == "spiked":
        t = (torch.arange(L, device=device) // 128) % 3 == 1
        delta = delta + 40.0 * t[:, None]
    elif kind == "mixed":
        t = (torch.arange(L, device=device) // 128) % 3 == 1
        delta = delta + 2.0 * (t[:, None] & (torch.arange(
            D, device=device) % 2 == 0))
    return u, delta, A, B, C


@pytest.mark.parametrize("R,L,D,N_,kind,guarded", [
    (2, 256, 96, 16, "model", True), (1, 200, 50, 16, "mixed", True),
    (2, 300, 136, 4, "model", True), (1, 37, 40, 64, "benign", True),
    (1, 520, 32, 64, "mixed", True), (1, 256, 40, 16, "tripped", True),
    (1, 300, 64, 16, "benign", False), (1, 100, 40, 32, "mixed", True),
    (2, 128, 72, 4, "mixed", True), (1, 2000, 96, 32, "model", True)])
def test_mxu_kernel_matches_plain(cuda, R, L, D, N_, kind, guarded):
    """K7 forward (y, chunk states, last state) and backward (du, ddelta,
    dA, dB, dC with a nonzero gradient of the last state) against the plain
    versions: ragged L (200, 37, 300, 520, 100, 2000), one chunk (37, 100:
    one sub-block of the whole chunk; 128) and many, N = 4 / 16 / 32 / 64
    (groups of 16 states), guard-tripped and mixed inputs, and the
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


@pytest.mark.parametrize("kind", ["model", "mixed", "tripped"])
def test_mxu_tally_matches_the_guard(cuda, kind):
    """The forward and the backward kernel each count every unit once, in
    the form that the guard picks from the sub-blocks' sums of |delta| as
    ``block_drop`` takes them (ragged L padded with zeros, |A| per state),
    and the plain version counts the same."""
    R, L, D, N_ = 2, 1000, 40, 16
    u, delta, A, B, C = _mxu_inputs(20, R, L, D, N_, kind, cuda)
    T, S = scan_mxu._geometry(L)
    dsum = torch.nn.functional.pad(delta, (0, 0, 0, (-L) % S)).abs()
    dsum = dsum.reshape(R, -1, S, D).sum(2)
    n_ratio = int((dsum[..., None] * A.abs() < scan_mxu.MAX_BLOCK_DROP).sum())
    want = (n_ratio, dsum.numel() * N_ - n_ratio)
    with scan_mxu.tally() as tf:
        _, st = scan_mxu._launch(u, delta, A, B, C, T, S, True)
    with scan_mxu.tally() as tb:
        scan_mxu._launch_bwd(u, delta, A, B, C, torch.randn_like(u),
                             torch.randn(R, D, N_, device=cuda), st, T, S,
                             True)
    with scan_mxu.tally() as tp:
        scan_mxu.selective_scan_mxu_core_ref(u, delta, A, B, C)
    assert (tf.ratio, tf.step) == want
    assert (tb.ratio, tb.step) == want
    assert (tp.ratio, tp.step) == want


@pytest.mark.parametrize("L,kind", [(2000, "mixed"), (100, "model")])
def test_mxu_kernel_is_deterministic(cuda, L, kind):
    """Two launches of K7's forward and of its backward on the same
    inputs give the same bits (the look-backs fold in one order wherever a
    walk stops; dB / dC are summed in a fixed order)."""
    R, D = 2, 136
    u, delta, A, B, C = _mxu_inputs(21, R, L, D, 16, kind, cuda)
    T, S = scan_mxu._geometry(L)
    dy = torch.randn(R, L, D, device=cuda)
    dlast = torch.randn(R, D, 16, device=cuda)
    runs = []
    for _ in range(2):
        y, st = scan_mxu._launch(u, delta, A, B, C, T, S, True)
        runs.append((y, st, *scan_mxu._launch_bwd(u, delta, A, B, C, dy,
                                                   dlast, st, T, S, True)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sub", [16, 8, 64])
def test_mxu_forward_sub_blocks(cuda, sub):
    """K7's forward at sub-blocks of 16, 8 and 64 steps (64: wider than the
    staging sub-chunk, so the whole chunk is staged before sweep 1) against
    the plain forward, on mixed inputs over many chunks and a ragged L."""
    R, L, D = 2, 1100, 72
    u, delta, A, B, C = _mxu_inputs(22, R, L, D, 16, "mixed", cuda)
    T, S = scan_mxu._geometry(L, sub_block=sub)
    y, st = scan_mxu._launch(u, delta, A, B, C, T, S, True)
    y_p, st_p = scan_mxu.selective_scan_mxu_core_ref(
        u, delta, A, B, C, sub_block=sub, return_states=True)
    _close(y, y_p, F32)
    _close(st, st_p, F32)


_ONE_KERNEL_CHILD = """
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from segmamba_tpu_torch.ops import scan_mxu
g = torch.Generator(device="cuda").manual_seed(23)
R, L, D = 2, 4096, 96
rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
u, B, C, dy = rn(R, L, D), rn(R, L, 16), rn(R, L, 16), rn(R, L, D)
delta = torch.nn.functional.softplus(rn(R, L, D) - 2.0)
A, dlast = -torch.exp(rn(D, 16)), rn(R, D, 16)
T, S = scan_mxu._geometry(L)
fwd = lambda: scan_mxu._launch(u, delta, A, B, C, T, S, True)
st = fwd()[1]
bwd = lambda: scan_mxu._launch_bwd(u, delta, A, B, C, dy, dlast, st, T, S,
                                   True)
fwd(), bwd()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    fwd()
    bwd()
    torch.cuda.synchronize()
print(json.dumps({e.key: e.count for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and e.self_device_time_total > 0}))
"""


def test_mxu_scan_is_one_kernel_each_way(cuda):
    """One K7 forward and one backward call (16 states) each run one scan
    kernel on the card, beside the zero fill of the flags and the
    wrapper's sums: no chunk or carry pass. Profiled in a fresh process (a
    later profiler session in a long one can come back without the card's
    kernels), taken again once if it comes back empty."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _ONE_KERNEL_CHILD],
                              capture_output=True, text=True, timeout=600,
                              cwd=root)
        assert proc.returncode == 0, proc.stderr[-3000:]
        counts = json.loads(proc.stdout.strip().splitlines()[-1])
        if counts:
            break
    for name in ("mxu_fwd_kernel", "mxu_bwd_kernel"):
        scans = [k for k in counts if name in k]
        assert len(scans) == 1 and counts[scans[0]] == 1, counts
    others = [k for k in counts
              if "mxu_fwd_kernel" not in k and "mxu_bwd_kernel" not in k]
    assert not any("mxu" in k or "scan" in k for k in others), others


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


def _f64_core(ref, u, delta, A, B, C, dy, dlast):
    """A plain core (``scan_core.selective_scan_core_ref`` or
    ``scan_mxu.selective_scan_mxu_core_ref``) run in float64: (y, chunk
    states, du, ddelta, dA, dB, dC) as float32 tensors."""
    leaves = [t.detach().double().requires_grad_()
              for t in (u, delta, A, B, C)]
    y, st = ref(*leaves, return_states=True)
    last = scan_core._last_state(st)
    grads = torch.autograd.grad((y, last), leaves, (dy.double(),
                                                    dlast.double()))
    return [t.detach().float() for t in (y, st, *grads)]


@pytest.mark.parametrize("R,L,D", [(1, 1000, 384), (2, 520, 96)])
def test_k6_k7_on_spiked_input_match_float64(cuda, R, L, D):
    """K6 and K7 on delta + 40 every third chunk, held against a float64
    run of their own plain versions at the f32 tier (forward y and chunk
    states, all five gradients with a nonzero gradient of the last state).
    With this file's deltas (softplus of N(-1, 0.5), near 0.3) all five
    hold; with model-range deltas (0.001-0.1, chip_smoke.py phase 14)
    ddelta cancels terms thousands of times its size after a spiked chunk
    and no float32 implementation, the plain versions included, meets the
    tier there (phase 14 reports it)."""
    u, delta, A, B, C = _mxu_inputs(19, R, L, D, 16, "spiked", cuda)
    dy = torch.randn(R, L, D, device=cuda)
    dlast = torch.randn(R, D, 16, device=cuda)
    T, S = scan_mxu._geometry(L)
    runs = {
        "K6": (lambda *a: scan_core._ScanCore.apply(T, *a),
               lambda *a, **k: scan_core.selective_scan_core_ref(
                   *a, chunk_size=T, **k),
               lambda: scan_core._launch(u, delta, A, B, C, T)[1]),
        "K7": (lambda *a: scan_mxu._MxuCore.apply(T, S, True, *a),
               lambda *a, **k: scan_mxu.selective_scan_mxu_core_ref(
                   *a, chunk_size=T, **k),
               lambda: scan_mxu._launch(u, delta, A, B, C, T, S, True)[1]),
    }
    for name, (kernel, plain, states) in runs.items():
        want = _f64_core(plain, u, delta, A, B, C, dy, dlast)
        leaves = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
        y, last = kernel(*leaves)
        torch.autograd.backward((y, last), (dy, dlast))
        _close(y, want[0], F32)
        _close(states(), want[1], F32)
        for g, leaf, w in zip(("du", "ddelta", "dA", "dB", "dC"), leaves,
                              want[2:]):
            _grad_close(f"{name} {g} {(R, L, D)}", leaf.grad, w, F32)


# d_state other than 16: the wrappers' groups of 16 states (K1-K5, K8)
GROUP_CALLS = {
    "dir_reverse": dict(reverse=True, gate=False, acc=False),
    "dir_gate_acc": dict(reverse=False, gate=True, acc=True),
    "fused": dict(fused=True),
    "slice": dict(nslices=8),
}


@pytest.mark.parametrize("N_", [4, 32])
@pytest.mark.parametrize("call", list(GROUP_CALLS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_state_groups_match_plain(cuda, N_, call, dtype):
    """K1-K5 at d_state 4 (one launch, zero-padded states) and 32 (two
    launches chained through acc): output, chunk states and every gradient
    against the plain versions at the full N; ceil(N / 16) launches each
    way."""
    R, L, D = 2, 320, 96
    u, dt, z, acc, B, C, A, Dv, bias = _inputs(20 + N_, R, L, D, dtype,
                                               False, True, cuda, N=N_)
    kw = dict(GROUP_CALLS[call])
    groups = -(-N_ // 16)
    if call == "fused":
        mod, counter, fn = scan_fused, "LAUNCHES", scan_fused.mamba_scan_fused
        ref, bwd_ref = (scan_fused.mamba_scan_fused_ref,
                        scan_fused.mamba_scan_fused_bwd_ref)
        kw, inputs = {}, [u, dt, z, None]
    elif call == "slice":
        mod, counter = scan_dir, "SLICE_LAUNCHES"
        fn, ref, bwd_ref = (scan_dir.mamba_scan_fused_slice,
                            scan_dir.mamba_scan_fused_slice_ref,
                            scan_dir.mamba_scan_fused_slice_bwd_ref)
        inputs = [u, dt, z, None]
    else:
        mod, counter = scan_dir, "LAUNCHES"
        fn, ref, bwd_ref = (scan_dir.mamba_scan_fused_dir,
                            scan_dir.mamba_scan_fused_dir_ref,
                            scan_dir.mamba_scan_fused_dir_bwd_ref)
        inputs = [u, dt, z if kw["gate"] else None,
                  acc if kw.pop("acc") else None]
    u, dt, zz, a = inputs
    extra = {} if a is None else {"acc": a}
    args = (u, dt, zz, A, B, C, Dv, bias)
    bwd_counter = counter.replace("LAUNCHES", "BWD_LAUNCHES")
    before = getattr(mod, counter), getattr(mod, bwd_counter)
    got, st = fn(*args, return_states=True, **kw, **extra)
    want, st_ref = ref(*args, return_states=True, **kw, **extra)
    _close(got, want, TOL[dtype])
    _close(st, st_ref, F32)
    dout = torch.randn(R, L, D, device=cuda).to(dtype)
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (u, dt, zz, a, A, B, C, Dv, bias)]
    lu, ldt, lz, la, *rest = leaves
    extra = {} if la is None else {"acc": la}
    fn(lu, ldt, lz, *rest, **kw, **extra).backward(dout)
    assert (getattr(mod, counter) - before[0],
            getattr(mod, bwd_counter) - before[1]) == (2 * groups,
                                                            groups)
    extra = {} if a is None else {"acc": a}
    want = bwd_ref(*args, dout, **kw, **extra)
    for name, leaf, w in zip(GRADS, leaves, want):
        if leaf is None:
            continue
        assert leaf.grad.shape == leaf.shape
        _grad_close(f"{name} N={N_} {call}", leaf.grad, w, TOL[dtype])


@pytest.mark.parametrize("N_", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_state_groups_match_plain(cuda, N_, dtype):
    """K8 at d_state 4 and 32 in its three chain links: output, chunk
    states and all eight gradients against the plain versions."""
    b, L, D, rank = 2, 300, 96, 3
    xc, _, dtp, bias, _, Dv, z, acc = _proj_inputs(21, b, L, D, rank, dtype,
                                                   cuda)
    rng = np.random.default_rng(N_)
    wp = torch.from_numpy((0.1 * rng.standard_normal(
        (D, rank + 2 * N_))).astype(np.float32)).to(cuda).to(dtype)
    A = -torch.exp(torch.from_numpy(rng.standard_normal(
        (D, N_)).astype(np.float32))).to(cuda)
    groups = -(-N_ // 16)
    for zk, acck, reverse in ((False, False, False), (False, True, True),
                              (True, True, False)):
        kw = dict(z=z if zk else None, acc=acc if acck else None,
                  reverse=reverse)
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
        scan_proj.mamba_scan_proj(*leaves[:6], z=leaves[6], acc=leaves[7],
                                  reverse=reverse).backward(dout)
        assert (scan_proj.LAUNCHES - before[0],
                scan_proj.BWD_LAUNCHES - before[1]) == (2 * groups, groups)
        want = scan_proj.mamba_scan_proj_bwd_ref(*args, dout, **kw)
        for name, leaf, w in zip(("dxc", "dx_proj", "ddt_proj", "ddt_bias",
                                  "dA", "dD", "dz", "dacc"), leaves, want):
            if leaf is None:
                continue
            _grad_close(f"{name} N={N_} z={zk} acc={acck}", leaf.grad, w,
                        TOL[dtype])


COMPOSITION_LAUNCHES = {   # per MambaV3 call and group of 16 states
    ("dir2", False): dict(scan_dir=2, scan_fused=1),
    ("dir", False): dict(scan_dir=2, scan_fused=1),
    ("dir", True): dict(scan_dir=2, scan_dir_slice=1),
    ("fused", False): dict(scan_fused=1),
    ("proj", False): dict(scan_proj=3),
}


def _launches():
    return dict(scan_dir=scan_dir.LAUNCHES, scan_fused=scan_fused.LAUNCHES,
                scan_dir_slice=scan_dir.SLICE_LAUNCHES,
                scan_proj=scan_proj.LAUNCHES)


@pytest.mark.parametrize("d_state", [4, 32])
@pytest.mark.parametrize("comp", list(COMPOSITION_LAUNCHES))
def test_mamba_v3_d_state_kernels_match_plain(cuda, d_state, comp):
    """``MambaV3(d_state=4)`` and ``(d_state=32)`` under each composition
    on the card (the kernels, ceil(N / 16) launches per scan call) against
    the same module on the CPU (the plain versions): output and every
    parameter gradient, float32."""
    scan_impl, slice_kernel = comp
    h = np.random.default_rng(22).standard_normal((2, 512, 48)).astype(
        np.float32)
    grads, outs = [], []
    for device in (cuda, torch.device("cpu")):
        m = MambaV3(d_model=48, d_state=d_state, nslices=8,
                    scan_impl=scan_impl, slice_kernel=slice_kernel,
                    generator=torch.Generator().manual_seed(0),
                    device=device)
        before = _launches()
        out = m(torch.from_numpy(h).to(device))
        out.square().mean().backward()
        if device == cuda:
            assert m.composition(device) == scan_impl
            moved = {k: v - before[k] for k, v in _launches().items()}
            groups = -(-d_state // 16)
            want = {k: n * groups for k, n in
                    COMPOSITION_LAUNCHES[comp].items()}
            assert moved == {**dict.fromkeys(moved, 0), **want}
        outs.append(out.detach().cpu())
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
    _close(outs[0], outs[1], F32)
    for k, w in grads[1].items():
        _grad_close(k, grads[0][k], w, F32)


CONV_SHAPES = [(2, 5, 7, 9, 4, 6), (1, 6, 10, 12, 48, 48),
               (1, 4, 9, 17, 96, 48), (1, 3, 5, 6, 192, 96),
               (1, 3, 16, 16, 48, 4),
               (2, 8, 15, 30, 192, 192),
               (1, 3, 19, 37, 48, 48),     # H, W that no bf16 tile divides
               (2, 1, 11, 13, 16, 32),     # D = 1 (one depth tap), B = 2
               (1, 3, 10, 12, 8, 16),      # Cin 8: TMA, half-empty K chunk
               (1, 2, 9, 10, 24, 48),      # Cin 24: ragged last K chunk
               (1, 3, 9, 20, 4, 48),       # Cin 4: cp.async halo, one chunk
               (1, 2, 6, 9, 24, 200)]      # Cout 200: two N tiles of 128
# B, D, H, W, Cin, Cout


def _conv_inputs(shape, dtype, device):
    B, D, H, W, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32)).to(device)
    return (f(B, D, H, W, cin).to(dtype),
            f(3, 3, 3, cin, cout, sc=(27 * cin) ** -0.5),
            f(B, D, H, W, cout).to(dtype))


def _ring_laps(x, cout):
    """Whether a block of the forward or of dw runs through its ring of
    stages (at most 8) more than once: bf16, a forward tile's depth taps x
    16-channel chunks, or a dw part's units x (planes + 2), above 8;
    float32 dw, more position tiles than partials."""
    B, D, H, W, cin = x.shape
    if x.dtype != torch.bfloat16:
        nparts, tiles = conv3d._dw_parts(x, cout)
        return nparts < tiles
    tile_stages = min(3, D) * -(-cin // 16)
    _, nparts, dsplit, units = conv3d._dw_plan(
        x.shape, cout, conv3d._sm_count(x.device))
    dw_stages = -(-units // nparts) * (-(-D // dsplit) + 2)
    return tile_stages > 8 or dw_stages > 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_kernels_match_plain(cuda, dtype):
    """K9 forward, dx and dw against the plain versions (float32 sums of 27
    shifted products) at ragged shapes: Cin = 4 (K = 108; the bf16 halo by
    cp.async), Cin 8 and 24 (the tensor-map halo with a half-empty or
    ragged last 16-channel chunk), H and W that no tile divides, D = 1, B
    = 2, Cout = 4 / 6 (masked output tiles) and 200 (two output-channel
    tiles); through ``conv3d_k3s1`` and ``conv3d_k3s1_v2`` with their
    autograd Function: two forward-kernel launches (y, dx) and one dw
    launch per call. y and dx at the dtype's tier; dw (float32 sums of
    products exact in float32) at the f32 tier with the absolute part
    scaled by max(1, max|plain|). Some shape makes a block run through its
    ring of stages more than once (forward or dw)."""
    laps = False
    for shape, fn in itertools.product(
            CONV_SHAPES, (conv3d.conv3d_k3s1, conv3d.conv3d_k3s1_v2)):
        B, D, H, W, cin, cout = shape
        x, w, dy = _conv_inputs(shape, dtype, cuda)
        laps |= _ring_laps(x, cout)
        lx, lw = x.detach().requires_grad_(), w.detach().requires_grad_()
        before = conv3d.LAUNCHES, conv3d.DW_LAUNCHES
        y = fn(lx, lw)
        assert y.dtype == dtype and y.shape == (B, D, H, W, cout)
        y.backward(dy)
        assert (conv3d.LAUNCHES - before[0],
                conv3d.DW_LAUNCHES - before[1]) == (2, 1)
        _close(y, conv3d.conv3d_k3s1_ref(x, w), TOL[dtype])
        dx = conv3d.conv3d_k3s1_ref(dy, conv3d._flip_w(w))
        assert lx.grad.dtype == dtype and lw.grad.dtype == torch.float32
        _close(lx.grad, dx, TOL[dtype])
        _grad_close(f"dw {shape}", lw.grad, conv3d.conv3d_k3s1_dw_ref(x, dy),
                    F32)
        with torch.no_grad():
            fn(x, w)
        assert conv3d.LAUNCHES - before[0] == 3
    assert laps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_kernels_give_the_same_bits_twice(cuda, dtype):
    """Two launches of the forward, of dx and of dw on the same inputs give
    the same bits: the dw partials are added in part order, no atomics."""
    for shape in [(1, 6, 10, 12, 48, 48), (2, 8, 15, 30, 192, 192),
                  (1, 3, 9, 20, 4, 48)]:
        x, w, dy = _conv_inputs(shape, dtype, cuda)
        for run in (lambda: conv3d._launch(x, w),
                    lambda: conv3d._launch(dy, w, flip=True),
                    lambda: conv3d._launch_dw(x, dy)):
            assert torch.equal(run(), run())


def test_conv3d_unaligned_and_strided_views(cuda):
    """x and dy as views whose data does not start on 16 bytes, and as
    permuted (non-contiguous) views: the wrappers copy them; the results
    equal those of the contiguous tensors."""
    shape = (1, 3, 9, 11, 48, 24)
    x, w, dy = _conv_inputs(shape, torch.bfloat16, cuda)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    ux = flat[1:].view(x.shape)
    ux.copy_(x)
    assert ux.data_ptr() % 16 != 0
    px = x.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
    assert not px.is_contiguous()
    want_y, want_dw = conv3d._launch(x, w), conv3d._launch_dw(x, dy)
    for v in (ux, px):
        assert torch.equal(conv3d._launch(v, w), want_y)
        assert torch.equal(conv3d._launch_dw(v, dy), want_dw)


@pytest.mark.parametrize("cin,cout,flip", [(48, 48, False), (4, 6, False),
                                           (24, 200, True), (192, 96, True)])
def test_conv3d_pack_kernel_matches_plain_layout(cuda, cin, cout, flip):
    """``conv3d_k3s1_pack`` (the bf16 weights in the stage layout, cast and,
    for dx, flipped and transposed in one launch) equals
    ``pack_weights_ref``, from float32 and from bf16 weights."""
    rng = np.random.default_rng(cin + cout)
    shape = (3, 3, 3, cout, cin) if flip else (3, 3, 3, cin, cout)
    w32 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda)
    n, ntn = conv3d._pick_n(cout)
    nch = -(-cin // 16)
    lib = conv3d._lib()
    for w in (w32, w32.to(torch.bfloat16)):
        wp = torch.empty(ntn * 3 * nch * 9 * 2 * n * 8, dtype=torch.bfloat16,
                         device=cuda)
        err = lib.conv3d_k3s1_pack(
            w.data_ptr(), int(w.dtype == torch.bfloat16), wp.data_ptr(), cin,
            cout, nch, n, ntn, int(flip),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(wp, conv3d.pack_weights_ref(w, cin, cout, n,
                                                       flip))


def _probe_args(seed, R, L, D, dtype, device):
    """(u, dt, z, A, B, C, D, dt_bias) for the K10 / K11 entry points."""
    u, dt, z, _, B, C, A, Dv, bias = _inputs(seed, R, L, D, dtype, False,
                                             False, device)
    return u, dt, z, A, B, C, Dv, bias


@pytest.mark.parametrize("variant", bench_scan_lb.VARIANTS)
@pytest.mark.parametrize("R,L,D", [(2, 1024, 96), (1, 384, 40),
                                   (1, 16384, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_lb_kernel_matches_plain(cuda, variant, R, L, D, dtype):
    """K10 with its carry recomputed per chunk against the plain version's
    serial carry, one launch per call; ragged channel blocks at D = 40."""
    a = _probe_args(R + L + D, R, L, D, dtype, cuda)
    before = bench_scan_lb.LAUNCHES
    got = bench_scan_lb.variant_call(*a, variant)
    torch.cuda.synchronize()
    assert bench_scan_lb.LAUNCHES == before + 1
    _close(got, bench_scan_lb.variant_call_ref(*a, variant), TOL[dtype])


@pytest.mark.parametrize("R,L,D", [(2, 1024, 96), (1, 768, 20),
                                   (3, 512, 64), (1, 65536, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_flat_kernel_matches_plain_and_k2(cuda, R, L, D, dtype):
    """K11 against its plain version and against K2's kernel on the same
    inputs, one launch per call, the same bits from two launches (its
    look-back folds in chunk order); 512 chunks of look-back at L =
    65,536."""
    a = _probe_args(R + L + D + 1, R, L, D, dtype, cuda)
    before = bench_scan_flat.LAUNCHES
    got = bench_scan_flat.flat_call(*a)
    torch.cuda.synchronize()
    assert bench_scan_flat.LAUNCHES == before + 1
    _close(got, bench_scan_flat.flat_call_ref(*a), TOL[dtype])
    _close(got, scan_fused.mamba_scan_fused(*a), TOL[dtype])
    assert torch.equal(got, bench_scan_flat.flat_call(*a))


def test_scan_probes_reject_unsupported_operands(cuda):
    """L not a multiple of 128, another chunk, N != 16 and a meta tensor
    raise; nothing launches."""
    a = _probe_args(0, 1, 384, 32, torch.float32, cuda)
    before = (bench_scan_lb.LAUNCHES, bench_scan_flat.LAUNCHES)
    ragged = tuple(t[:, :300] if t.dim() == 3 else t for t in a)
    n8 = a[:3] + (a[3][:, :8], a[4][..., :8], a[5][..., :8]) + a[6:]
    for call in (lambda *x, **k: bench_scan_lb.variant_call(*x, "nohs", **k),
                 bench_scan_flat.flat_call):
        with pytest.raises(ValueError, match="multiple of T"):
            call(*ragged)
        with pytest.raises(ValueError, match="T = 128"):
            call(*a, T=64)
        with pytest.raises(ValueError, match="N = 16"):
            call(*n8)
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(*(t.to("meta") for t in a))
    assert (bench_scan_lb.LAUNCHES, bench_scan_flat.LAUNCHES) == before


def test_whole_volume_kernel_path_matches_plain(cuda):
    """Full-width SegMamba over a non-cubic volume with a crop (box (32, 48,
    32) of a (40, 70, 50) frame, slices 16/8/4/2 from its depth): kernels
    vs plain scans in float32, 16 K1 and 8 K2 launches, class 0 pinned at
    20.0 outside the box; the stored slice counts come back."""
    from segmamba_tpu_torch.infer import whole_volume as twv
    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     device=cuda).eval()
    x = np.zeros((1, 4, 40, 70, 50), np.float32)
    x[:, :, 5:34, 10:50, 12:40] = np.random.default_rng(5).standard_normal(
        (1, 4, 29, 40, 28))
    x = torch.from_numpy(x).to(cuda)
    box = twv.nonzero_bbox(x)
    assert box == ((5, 37), (10, 58), (12, 44))
    before = (scan_dir.LAUNCHES, scan_fused.LAUNCHES)
    got = twv.whole_volume_inference(model, x)
    torch.cuda.synchronize()
    assert (scan_dir.LAUNCHES - before[0],
            scan_fused.LAUNCHES - before[1]) == (16, 8)
    saved = scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused
    scan_dir.mamba_scan_fused_dir = scan_dir.mamba_scan_fused_dir_ref
    scan_fused.mamba_scan_fused = scan_fused.mamba_scan_fused_ref
    try:
        want = twv.whole_volume_inference(model, x)
    finally:
        scan_dir.mamba_scan_fused_dir, scan_fused.mamba_scan_fused = saved
    assert got.shape == (1, 4, 40, 70, 50)
    _close(got, want, (2e-3, 1e-2 * float(want.abs().max())))
    outside = torch.ones(40, 70, 50, dtype=torch.bool, device=cuda)
    outside[5:37, 10:58, 12:44] = False
    assert bool((got[0, 0][outside] == 20.0).all())
    assert bool((got[0, 1:][:, outside] == 0).all())
    assert model.num_slices_list == (64, 32, 16, 8)


def test_load_model_weights_round_trips_a_trainer_checkpoint(cuda, tmp_path):
    """A checkpoint of the trainer's ``save_checkpoint``, written from the
    card, loads into a fresh model on the card with every tensor equal and
    the same logits; a reference-format ``state_dict`` too."""
    import types
    from segmamba_tpu_torch.train.checkpoint import (
        load_model_weights,
        save_checkpoint,
    )
    cfg = dict(in_chans=4, out_chans=4, depths=(1, 1, 1, 1),
               feat_size=(8, 16, 32, 64), hidden_size=128,
               num_slices_list=(16, 8, 4, 2))
    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     device=cuda, **cfg).eval()
    state = types.SimpleNamespace(
        model=model, step=3,
        optimizer=torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    path = save_checkpoint(state, str(tmp_path / "best_model_0.5000.pt"),
                           epoch=1, metric=0.5)
    ref = str(tmp_path / "reference.pt")
    torch.save({"state_dict": {f"module.{k}": v.cpu() for k, v in
                               model.state_dict().items()}}, ref)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 4, 32, 32, 32)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        want = model(x)
    for p in (path, ref):
        fresh = SegMamba(generator=torch.Generator().manual_seed(1),
                         device=cuda, **cfg).eval()
        assert load_model_weights(fresh, p) is fresh
        for k, v in model.state_dict().items():
            got = fresh.state_dict()[k]
            assert got.device.type == "cuda" and torch.equal(got, v), k
        with torch.inference_mode():
            assert torch.equal(fresh(x), want)
