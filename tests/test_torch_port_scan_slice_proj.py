"""The slice-order scan (K5) and the projection-fused scan (K8) of the port
vs the JAX package, on the CPU.

The port's entry points on CPU tensors run their plain versions (and, with
grad, their ``torch.autograd.Function``'s plain backward); the JAX entry
points run the Pallas kernels in interpret mode, as the JAX package's own
tests run them (tests/test_scan_dir.py:118-189, tests/test_scan_proj.py).
Same numpy-seeded inputs. Tolerances:
- float32 outputs rtol = atol = 2e-4 (the scan tier of
  tests/test_torch_port_scan.py);
- gradients rtol 2e-4 / atol 2e-5 of max(1, max|JAX|) (the JAX package's
  tier for these gradients, tests/test_scan_dir.py:114, with the absolute
  part scaled for the reduced sums over steps and channels);
- bfloat16 I/O of K8: the port against JAX in float32 at 8e-2 (JAX's own
  bf16 tier for this kernel, tests/test_scan_proj.py:115).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.ops.causal_conv1d import causal_conv1d_grouped as j_grouped
from segmamba_tpu.ops.scan_pallas_dir import (
    mamba_scan_fused_slice as j_slice,
)
from segmamba_tpu.ops.scan_pallas_dir import (
    slice_scan_supported as j_slice_supported,
)
from segmamba_tpu.ops.scan_pallas_proj import mamba_scan_proj as j_proj
from segmamba_tpu_torch.ops import scan_dir, scan_proj
from segmamba_tpu_torch.ops.causal_conv1d import causal_conv1d_grouped

N = 16
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _grad_close(name, got, want):
    want = np.asarray(want)
    atol = GRAD_ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=GRAD_RTOL, atol=atol, err_msg=name)


def _slice_inputs(seed, R, L, D):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return dict(u=f(R, L, D), dt=f(R, L, D, sc=0.3), z=f(R, L, D),
                A=-np.exp(f(R, D, N, sc=0.5)), B=f(R, L, N), C=f(R, L, N),
                D=f(R, D), bias=f(R, D, sc=0.3), dout=f(R, L, D))


SLICE_ARGS = ("u", "dt", "z", "A", "B", "C", "D", "bias")


@pytest.mark.parametrize("R,L,D,S", [(1, 64, 8, 8), (2, 96, 20, 4),
                                     (1, 64, 136, 8)])
def test_slice_scan_matches_jax(R, L, D, S):
    """Forward; (1, 64, 136) pads channels to JAX's 128-lane block (the
    channel axis of A, ROADMAP C note 2), the port masks them."""
    a = _slice_inputs(1, R, L, D)
    want = j_slice(*(jnp.asarray(a[k]) for k in SLICE_ARGS), nslices=S,
                   chunk_size=32, d_block=128)
    got = scan_dir.mamba_scan_fused_slice(
        *(torch.from_numpy(a[k]) for k in SLICE_ARGS), nslices=S,
        chunk_size=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_slice_scan_grads_match_jax():
    R, L, D, S = 2, 64, 8, 8
    a = _slice_inputs(2, R, L, D)

    def loss(*args):
        out = j_slice(*args, nslices=S, chunk_size=32)
        return jnp.sum(out * jnp.asarray(a["dout"]))

    want = jax.grad(loss, argnums=tuple(range(8)))(
        *(jnp.asarray(a[k]) for k in SLICE_ARGS))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in SLICE_ARGS]
    out = scan_dir.mamba_scan_fused_slice(*leaves, nslices=S, chunk_size=32)
    out.backward(torch.from_numpy(a["dout"]))
    for name, leaf, w in zip(SLICE_ARGS, leaves, want):
        _grad_close(name, leaf.grad, w)


def test_slice_scan_supported_is_wider_than_jax():
    """Any S >= 2 dividing L; JAX also needs its block rule (Tp | P)."""
    assert scan_dir.slice_scan_supported(36, 6)
    assert not j_slice_supported(36, 6)
    assert scan_dir.slice_scan_supported(64, 8) and j_slice_supported(64, 8)
    assert not scan_dir.slice_scan_supported(50, 8)
    assert not scan_dir.slice_scan_supported(64, 1)
    with pytest.raises(ValueError, match="nslices"):
        z = torch.zeros(1, 50, 4)
        scan_dir.mamba_scan_fused_slice(
            z, z, z, torch.zeros(4, N), torch.zeros(1, 50, N),
            torch.zeros(1, 50, N), torch.zeros(4), torch.zeros(4),
            nslices=8)


def test_slice_scan_ref_is_interleaved_fused_scan():
    """The plain version and its states equal the fused scan on the
    interleaved sequence (scan-order chunks)."""
    R, L, D, S = 1, 48, 6, 6
    a = {k: torch.from_numpy(v)
         for k, v in _slice_inputs(3, R, L, D).items()}
    args = [a[k] for k in SLICE_ARGS]
    out, st = scan_dir.mamba_scan_fused_slice(*args, nslices=S,
                                              chunk_size=16,
                                              return_states=True)
    il = lambda t: scan_dir._interleave(t, S)
    want, st_w = scan_dir.mamba_scan_fused_dir_ref(
        il(a["u"]), il(a["dt"]), il(a["z"]), a["A"], il(a["B"]),
        il(a["C"]), a["D"], a["bias"], chunk_size=16, return_states=True)
    torch.testing.assert_close(out, scan_dir._deinterleave(want, S))
    torch.testing.assert_close(st, st_w)


def _proj_inputs(seed, b, L, D, rank, dtype=np.float32):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return dict(xc=f(b, L, D).astype(dtype), z=f(b, L, D).astype(dtype),
                acc=f(b, L, D).astype(dtype),
                x_proj=(f(D, rank + 2 * N, sc=0.1)).astype(dtype),
                dt_proj=f(rank, D, sc=0.3), dt_bias=f(D, sc=0.5),
                A=-np.exp(f(D, N)), Dv=f(D))


PROJ_ARGS = ("xc", "x_proj", "dt_proj", "dt_bias", "A", "Dv")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L,D,rank", [(136, 16, 3), (40, 24, 8)])
def test_proj_scan_matches_jax(reverse, L, D, rank):
    a = _proj_inputs(4, 2, L, D, rank)
    for zk, acck in ((True, True), (False, True), (False, False),
                     (True, False)):
        kw = dict(reverse=reverse)
        want = j_proj(*(jnp.asarray(a[k]) for k in PROJ_ARGS),
                      z=jnp.asarray(a["z"]) if zk else None,
                      acc=jnp.asarray(a["acc"]) if acck else None, **kw)
        got = scan_proj.mamba_scan_proj(
            *(torch.from_numpy(a[k]) for k in PROJ_ARGS),
            z=torch.from_numpy(a["z"]) if zk else None,
            acc=torch.from_numpy(a["acc"]) if acck else None, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"z={zk} acc={acck}")


def test_proj_chain_grads_match_jax():
    """The three-orientation chain (slice ungated -> reverse with acc ->
    forward with acc and z), all nine gradients, vs ``jax.grad`` through
    the JAX kernels' custom VJPs."""
    rng = np.random.default_rng(5)
    b, L, D, rank = 1, 136, 24, 3
    a = _proj_inputs(5, b, L, D, rank)
    f = lambda: rng.standard_normal((b, L, D)).astype(np.float32)
    xcr, xcs, cot = f(), f(), f()
    names = ("xcf", "xcr", "xcs", "z", "x_proj", "dt_proj", "dt_bias", "A",
             "Dv")
    vals = (a["xc"], xcr, xcs, a["z"], a["x_proj"], a["dt_proj"],
            a["dt_bias"], a["A"], a["Dv"])

    def chain(run, args):
        xcf, xcr, xcs, z, wp, dtp, bias, A, Dv = args
        ys = run(xcs, wp, dtp, bias, A, Dv)
        yr = run(xcr, wp, dtp, bias, A, Dv, acc=ys, reverse=True)
        return run(xcf, wp, dtp, bias, A, Dv, acc=yr, z=z)

    want = jax.grad(lambda args: jnp.sum(chain(j_proj, args) * cot))(
        tuple(jnp.asarray(v) for v in vals))
    leaves = [torch.from_numpy(v).requires_grad_() for v in vals]
    chain(scan_proj.mamba_scan_proj, leaves).backward(torch.from_numpy(cot))
    for name, leaf, w in zip(names, leaves, want):
        _grad_close(name, leaf.grad, w)


def test_proj_bf16_io_matches_jax():
    import ml_dtypes

    a = _proj_inputs(6, 1, 128, 32, 3)
    bf = lambda k: np.asarray(a[k]).astype(ml_dtypes.bfloat16)
    want = j_proj(jnp.asarray(bf("xc")), jnp.asarray(bf("x_proj")),
                  jnp.asarray(a["dt_proj"]), jnp.asarray(a["dt_bias"]),
                  jnp.asarray(a["A"]), jnp.asarray(a["Dv"]),
                  z=jnp.asarray(bf("z")))
    tb = lambda k: torch.from_numpy(a[k]).to(torch.bfloat16)
    got = scan_proj.mamba_scan_proj(
        tb("xc"), tb("x_proj"), torch.from_numpy(a["dt_proj"]),
        torch.from_numpy(a["dt_bias"]), torch.from_numpy(a["A"]),
        torch.from_numpy(a["Dv"]), z=tb("z"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=8e-2,
                               atol=8e-2)


def test_proj_scan_states_and_limits():
    """The plain version's chunk exit states are the directional scan's;
    d_inner > 128 raises (the caller falls back to the dir path)."""
    a = {k: torch.from_numpy(v)
         for k, v in _proj_inputs(7, 1, 200, 16, 2).items()}
    out, st = scan_proj.mamba_scan_proj(
        *(a[k] for k in PROJ_ARGS), z=a["z"], reverse=True,
        chunk_size=64, return_states=True)
    assert st.shape == (1, 4, N, 16)
    x_dbl = a["xc"] @ a["x_proj"]
    dt = x_dbl[..., :2] @ a["dt_proj"]
    want, st_w = scan_dir.mamba_scan_fused_dir_ref(
        a["xc"], dt, a["z"], a["A"], x_dbl[..., 2:2 + N],
        x_dbl[..., 2 + N:], a["Dv"], a["dt_bias"], reverse=True,
        chunk_size=64, return_states=True)
    torch.testing.assert_close(out, want)
    torch.testing.assert_close(st, st_w)
    assert scan_proj.proj_scan_supported(128)
    assert not scan_proj.proj_scan_supported(129)
    with pytest.raises(ValueError, match="d_inner"):
        scan_proj.mamba_scan_proj(torch.zeros(1, 8, 130),
                                  torch.zeros(130, 34), torch.zeros(2, 130),
                                  torch.zeros(130), torch.zeros(130, N),
                                  torch.zeros(130))


@pytest.mark.parametrize("groups,batch", [(3, 2), (2, 1)])
def test_causal_conv1d_grouped_matches_jax(groups, batch):
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((groups * batch, 37, 6)).astype(np.float32)
    w = rng.standard_normal((groups, 4, 6)).astype(np.float32)
    b = rng.standard_normal((groups, 6)).astype(np.float32)
    want = j_grouped(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), batch,
                     activation="silu")
    got = causal_conv1d_grouped(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), batch,
                                activation="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
