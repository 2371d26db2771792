"""Port scan ops vs the JAX package, on the CPU.

The plain PyTorch versions of the Hopper scan kernel's two entry points
(``segmamba_tpu_torch/ops/scan_dir.py`` ``mamba_scan_fused_dir_ref``,
``scan_fused.py`` ``mamba_scan_fused_ref``) against the JAX entry points
``mamba_scan_fused_dir`` / ``mamba_scan_fused`` with their Pallas kernels in
interpret mode, on the same numpy inputs. Tolerance: rtol = atol = 2e-4 in
float32, the tier of tests/test_scan_dir_chain.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segmamba_tpu.ops.scan_pallas import DEF_DBLOCK, _pick_dblock
from segmamba_tpu.ops.scan_pallas_dir import _dir_fwd_call, mamba_scan_fused_dir
from segmamba_tpu.ops.scan_pallas_fused import mamba_scan_fused
from segmamba_tpu.ops.selective_scan import selective_scan
from segmamba_tpu_torch.ops import _build, scan_dir, scan_fused
from segmamba_tpu_torch.ops import selective_scan as tscan

N = 16
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, R, L, D, per_row=True, n=N):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    pshape = (R, D) if per_row else (D,)
    return dict(u=f(R, L, D), dt=f(R, L, D, sc=0.2), z=f(R, L, D),
                acc=f(R, L, D), B=f(R, L, n), C=f(R, L, n),
                A=-np.exp(f(*pshape, n)), D=f(*pshape),
                bias=f(*pshape, sc=0.3))


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _jax_rows(a, R):
    """JAX dir entry takes per-row params: broadcast shared ones."""
    out = {k: jnp.asarray(v) for k, v in a.items()}
    for k, nd in (("A", 3), ("D", 2), ("bias", 2)):
        if out[k].ndim < nd:
            out[k] = jnp.broadcast_to(out[k], (R,) + out[k].shape)
    return out


def _run_dir(mod, a, gate, has_acc, reverse):
    return mod(a["u"], a["dt"], a["z"] if gate else None, a["A"], a["B"],
               a["C"], a["D"], a["bias"], acc=a["acc"] if has_acc else None,
               gate=gate, reverse=reverse)


# the flag sets the dir2 path runs (flip: reverse, ungated; forward: gate +
# acc), the ungated forward link, shared and per-row params, ragged L and D
@pytest.mark.parametrize("R,L,D,reverse,gate,has_acc,per_row", [
    (2, 320, 96, True, False, False, True),
    (2, 320, 96, False, True, True, True),
    (2, 320, 96, True, False, False, False),
    (2, 320, 96, False, True, True, False),
    (2, 320, 96, False, False, True, True),
    (2, 200, 50, True, False, False, True),
    (2, 200, 50, False, True, True, False),
])
def test_scan_dir_ref_matches_jax(R, L, D, reverse, gate, has_acc, per_row):
    a = _inputs(0, R, L, D, per_row=per_row)
    want = _run_dir(mamba_scan_fused_dir, _jax_rows(a, R), gate, has_acc,
                    reverse)
    got = _run_dir(scan_dir.mamba_scan_fused_dir, _torch(a), gate, has_acc,
                   reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("R,L,D,per_row", [
    (2, 320, 96, False),
    (2, 320, 96, True),
    (1, 200, 50, False),
    # dim > 128 makes the JAX wrapper pad channels (on A's channel axis,
    # not its state axis: the test_slice_scan_padded_channels regression)
    (1, 64, 136, False),
])
def test_scan_fused_ref_matches_jax(R, L, D, per_row):
    a = _inputs(1, R, L, D, per_row=per_row)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = mamba_scan_fused(j["u"], j["dt"], j["z"], j["A"], j["B"], j["C"],
                            j["D"], j["bias"])
    t = _torch(a)
    got = scan_fused.mamba_scan_fused(t["u"], t["dt"], t["z"], t["A"], t["B"],
                                      t["C"], t["D"], t["bias"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_chunk_states_match_jax_kernel(reverse):
    """The per-chunk exit states (scan order) equal the Pallas kernel's."""
    R, L, D, T = 1, 256, 96, 128
    a = _inputs(2, R, L, D)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    zeros = jnp.zeros_like(j["u"])
    _, want = _dir_fwd_call(
        j["u"], j["dt"], j["z"], zeros, jnp.swapaxes(j["A"], 1, 2),
        jnp.swapaxes(j["B"], 1, 2), jnp.swapaxes(j["C"], 1, 2),
        j["bias"][:, None], j["D"][:, None], T, _pick_dblock(D, DEF_DBLOCK),
        reverse, True, False)
    t = _torch(a)
    _, got = scan_dir.mamba_scan_fused_dir(
        t["u"], t["dt"], t["z"], t["A"], t["B"], t["C"], t["D"], t["bias"],
        reverse=reverse, chunk_size=T, return_states=True)
    assert got.shape == (R, L // T, N, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_selective_scan_cores_match_jax():
    """Module 3: the sequential and chunked plain cores vs JAX's ref core,
    with bias + softplus, D-skip and gate, shared A, ragged L."""
    rng = np.random.default_rng(3)
    b, L, D, n = 2, 100, 8, 4
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    u, dt, z, B, C = f(b, L, D), f(b, L, D, sc=0.5), f(b, L, D), f(b, L, n), \
        f(b, L, n)
    A, Dv, bias = -np.exp(f(D, n)), f(D), f(D, sc=0.3)
    want = selective_scan(*map(jnp.asarray, (u, dt, A, B, C)),
                          D=jnp.asarray(Dv), z=jnp.asarray(z),
                          delta_bias=jnp.asarray(bias), delta_softplus=True,
                          impl="ref")
    args = [torch.from_numpy(x) for x in (u, dt, A, B, C)]
    kw = dict(D=torch.from_numpy(Dv), z=torch.from_numpy(z),
              delta_bias=torch.from_numpy(bias), delta_softplus=True)
    ref = tscan.selective_scan_ref(*args, **kw)
    chunked = tscan.selective_scan_chunked(*args, chunk_size=32, **kw)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **TOL)


def test_chunked_core_no_overflow_at_s4d_range():
    """A down to -16 with large steps: the chunked core forms only decay
    products (no exp(-cumsum)), so it stays finite and equals the
    sequential core."""
    rng = np.random.default_rng(4)
    b, L, D, n = 1, 512, 4, N
    u = torch.from_numpy(rng.standard_normal((b, L, D)).astype(np.float32))
    delta = torch.full((b, L, D), 4.0)
    A = -torch.arange(1, n + 1, dtype=torch.float32).repeat(D, 1)
    B = torch.from_numpy(rng.standard_normal((b, L, n)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((b, L, n)).astype(np.float32))
    y, _ = tscan._core_chunked(u, delta, A, B, C)
    y_ref, _ = tscan._core_ref(u, delta, A, B, C)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)


def test_cpu_tensors_never_load_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError(f"kernel library {name} loaded for CPU tensors")

    monkeypatch.setattr(_build, "load_library", no_build)
    t = _torch(_inputs(5, 1, 64, 32, per_row=False))
    before = (scan_dir.LAUNCHES, scan_fused.LAUNCHES)
    scan_dir.mamba_scan_fused_dir(t["u"], t["dt"], t["z"], t["A"], t["B"],
                                  t["C"], t["D"], t["bias"], reverse=True)
    scan_fused.mamba_scan_fused(t["u"], t["dt"], t["z"], t["A"], t["B"],
                                t["C"], t["D"], t["bias"])
    assert (scan_dir.LAUNCHES, scan_fused.LAUNCHES) == before


def test_non_cpu_non_cuda_tensor_raises():
    """No silent fallback: a tensor that is neither on the CPU nor on a card
    (here the meta device) is refused, not sent to the plain version."""
    t = {k: v.to("meta") for k, v in _torch(_inputs(6, 1, 16, 32)).items()}
    with pytest.raises(ValueError, match="CUDA"):
        scan_dir.mamba_scan_fused_dir(t["u"], t["dt"], t["z"], t["A"],
                                      t["B"], t["C"], t["D"], t["bias"])
    with pytest.raises(ValueError, match="CUDA"):
        scan_fused.mamba_scan_fused(t["u"], t["dt"], t["z"], t["A"], t["B"],
                                    t["C"], t["D"], t["bias"])
