"""The port's selective scan (K6 wrapper and dispatcher), decode ops and
fused norms vs the JAX package, on the CPU.

- ``scan_core.selective_scan_kernel`` (its plain route on CPU tensors) and
  ``selective_scan(impl=...)`` against JAX's ``selective_scan_pallas``,
  which runs the Pallas kernel K6 in interpret mode here (as
  ``tests/test_selective_scan.py`` runs it): batch 2, L in {64, 200} (200 is
  ragged against chunks of 128), D = 24, N = 16, with and without
  D / z / bias / softplus. ``y`` and ``last_state`` at the float32 tier
  rtol 6e-4 / atol 2e-3; the gradients of a loss on both ``y`` and
  ``last_state`` (so through ``dlast``) against ``jax.grad`` at the same
  tier, the absolute part scaled by max(1, max|JAX|) for the gradients
  that are sums over steps or channels (A, B, C, D, bias).
- Grouped (batch, L, G, N), static (dim, N) and complex B/C against JAX's
  ``selective_scan_ref``.
- ``causal_conv1d_update``, ``selective_state_update``, ``layer_norm_fn``
  and ``rms_norm_fn`` against JAX.

Inputs come from ``numpy.random.default_rng(seed)`` and go to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.ops.causal_conv1d import (
    causal_conv1d_update as j_conv_update,
)
from segmamba_tpu.ops.fused_norm import layer_norm_fn as j_layer_norm_fn
from segmamba_tpu.ops.fused_norm import rms_norm_fn as j_rms_norm_fn
from segmamba_tpu.ops.scan_pallas import selective_scan_pallas
from segmamba_tpu.ops.selective_scan import (
    selective_scan_ref as j_selective_scan_ref,
)
from segmamba_tpu.ops.selective_state_update import (
    selective_state_update as j_ssu,
)
from segmamba_tpu_torch.ops import scan_core
from segmamba_tpu_torch.ops.causal_conv1d import causal_conv1d_update
from segmamba_tpu_torch.ops.fused_norm import layer_norm_fn, rms_norm_fn
from segmamba_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_chunked,
    selective_scan_ref,
)
from segmamba_tpu_torch.ops.selective_state_update import (
    selective_state_update,
)

F32 = dict(rtol=6e-4, atol=2e-3)
D_, N_ = 24, 16
REDUCED = ("A", "B", "C", "D", "bias")


def _inputs(seed, L, full, R=2):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    a = dict(u=f(R, L, D_), delta=f(R, L, D_, sc=0.5),
             A=-np.exp(f(D_, N_, sc=0.5)), B=f(R, L, N_), C=f(R, L, N_),
             gy=f(R, L, D_), glast=f(R, D_, N_))
    if full:
        a.update(D=f(D_), z=f(R, L, D_), bias=f(D_, sc=0.3))
    else:   # raw delta must be positive without softplus
        a["delta"] = np.abs(a["delta"]) * 0.2
    return a


ARGS = ("u", "delta", "A", "B", "C", "D", "z", "bias")


def _kw(a, full, mod):
    conv = jnp.asarray if mod == "jax" else torch.from_numpy
    kw = {k: conv(a[k]) for k in ARGS if k in a}
    kw["delta_bias"] = kw.pop("bias", None)
    return dict(kw, delta_softplus=full, return_last_state=True)


CASES = [(64, True), (64, False), (200, True), (200, False)]


@pytest.mark.parametrize("L,full", CASES)
def test_scan_matches_jax_pallas(L, full):
    a = _inputs(L + full, L, full)
    want_y, want_last = selective_scan_pallas(**_kw(a, full, "jax"))
    for name, fn in (("kernel", scan_core.selective_scan_kernel),
                     ("pallas", lambda **k: selective_scan(impl="pallas",
                                                           **k)),
                     ("auto", lambda **k: selective_scan(impl="auto", **k))):
        y, last = fn(**_kw(a, full, "torch"))
        assert y.shape == (2, L, D_) and last.shape == (2, D_, N_), name
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   err_msg=name, **F32)
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                                   err_msg=name, **F32)


@pytest.mark.parametrize("L,full", [(200, True), (64, False)])
def test_scan_grads_through_last_state_match_jax(L, full):
    """The loss reads y and the last state, so the backward carries a
    nonzero ``dlast`` into the last chunk (a ragged one at L = 200)."""
    a = _inputs(L + 7 * full, L, full)
    names = [k for k in ARGS if k in a]

    def jloss(*args):
        kw = _kw(dict(a, **dict(zip(names, args))), full, "jax")
        y, last = selective_scan_pallas(**kw)
        return jnp.sum(y * a["gy"]) + jnp.sum(last * a["glast"])

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(a[k]) for k in names))
    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in names}
    before = scan_core.LAUNCHES, scan_core.BWD_LAUNCHES
    y, last = scan_core.selective_scan_kernel(
        t["u"], t["delta"], t["A"], t["B"], t["C"], D=t.get("D"),
        z=t.get("z"), delta_bias=t.get("bias"), delta_softplus=full,
        return_last_state=True)
    assert y.grad_fn is not None and last.grad_fn is not None
    loss = (y * torch.from_numpy(a["gy"])).sum() + (
        last * torch.from_numpy(a["glast"])).sum()
    loss.backward()
    # the CPU route runs the plain versions: no kernel launch is counted
    assert (scan_core.LAUNCHES, scan_core.BWD_LAUNCHES) == before
    for k, w in zip(names, want):
        w = np.asarray(w)
        atol = F32["atol"] * (max(1.0, float(np.abs(w).max()))
                              if k in REDUCED else 1.0)
        np.testing.assert_allclose(t[k].grad.numpy(), w, rtol=F32["rtol"],
                                   atol=atol, err_msg=k)


def test_core_bwd_ref_is_the_functions_cpu_backward():
    """``selective_scan_core_bwd_ref`` gives exactly the gradients that
    ``_ScanCore``'s CPU backward hands to autograd."""
    a = _inputs(3, 136, False)
    leaves = [torch.from_numpy(a[k]).requires_grad_()
              for k in ("u", "delta", "A", "B", "C")]
    y, last = scan_core._ScanCore.apply(128, *leaves)
    gy, gl = torch.from_numpy(a["gy"]), torch.from_numpy(a["glast"])
    torch.autograd.backward((y, last), (gy, gl))
    want = scan_core.selective_scan_core_bwd_ref(
        *(t.detach() for t in leaves), gy, gl)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def _tier_shares(got, want):
    """|got - want| / (atol + rtol |want|) of every value, float64."""
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want) / (
        F32["atol"] + F32["rtol"] * np.abs(want))


def test_spiked_ddelta_matches_jax_float32_against_float64():
    """ddelta after a spike (delta + 40 on the second chunk of 128 steps,
    model-range deltas elsewhere): the port's plain float32 backward and
    JAX's K6 backward (Pallas, interpret mode) against a float64 run of the
    port's plain core. After the spike ddelta cancels terms thousands of
    times its size, so float32 rounding alone moves it; the port misses
    float64 by no more than twice the JAX package's own miss (root mean
    square of each value's share of the f32 tier; the largest share over
    these 3,072 values is a noisy extreme, 0.45-2.6x JAX's across seeds),
    and here both stay inside the tier."""
    rng = np.random.default_rng(0)
    R, L = 1, 384
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    A = (-np.arange(1, N_ + 1, dtype=np.float32) * np.exp(0.1 * f(8, N_))
         ).astype(np.float32)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), 8))
    bias = (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
    delta = np.logaddexp(f(R, L, 8, sc=0.5) + bias, 0.0).astype(np.float32)
    delta[:, 128:256] += 40.0
    u, B, C, gy = f(R, L, 8), f(R, L, N_), f(R, L, N_), f(R, L, 8)
    glast = f(R, 8, N_)

    def jloss(d):
        y, last = selective_scan_pallas(
            jnp.asarray(u), d, jnp.asarray(A), jnp.asarray(B),
            jnp.asarray(C), return_last_state=True)
        return jnp.sum(y * gy) + jnp.sum(last * glast)

    jax_dd = np.asarray(jax.grad(jloss)(jnp.asarray(delta)))
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(dt)
    port_dd = scan_core.selective_scan_core_bwd_ref(
        t(u), t(delta), t(A), t(B), t(C), t(gy), t(glast))[1].numpy()
    leaves = [t(a, torch.float64).requires_grad_()
              for a in (u, delta, A, B, C)]
    y, last = scan_core.selective_scan_core_ref(*leaves)
    want = torch.autograd.grad((y, last), leaves, (
        t(gy, torch.float64), t(glast, torch.float64)))[1].numpy()
    jax_s, port_s = _tier_shares(jax_dd, want), _tier_shares(port_dd, want)
    rms = lambda s: float(np.sqrt(np.mean(s ** 2)))
    assert rms(port_s) <= 2.0 * rms(jax_s), (rms(port_s), rms(jax_s))
    assert jax_s.max() <= 1.0 and port_s.max() <= 1.0, (jax_s.max(),
                                                        port_s.max())


def test_dispatcher_impls():
    a = _inputs(5, 64, True)
    kw = _kw(a, True, "torch")
    ref_y, ref_last = selective_scan_ref(**kw)
    for impl in ("auto", "pallas", "chunked", "ref", "mxu"):
        y, last = selective_scan(impl=impl, **kw)
        np.testing.assert_allclose(y.numpy(), ref_y.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=impl)
        np.testing.assert_allclose(last.numpy(), ref_last.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=impl)
    with pytest.raises(ValueError, match="unknown"):
        selective_scan(impl="nope", **kw)
    with torch.inference_mode():
        y = scan_core.selective_scan_kernel(**dict(kw,
                                                   return_last_state=False))
    assert y.grad_fn is None


def _weights(rng, kind, R, L):
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    c = lambda *s: (f(*s) + 1j * f(*s)).astype(np.complex64)
    A = -np.exp(f(D_, 4, sc=0.5))
    if kind == "grouped":
        return A, f(R, L, 2, 4), f(R, L, 3, 4)
    if kind == "static":
        return A, f(D_, 4), f(D_, 4)
    if kind == "complex_A":
        return (A + 1j * f(D_, 4)).astype(np.complex64), f(R, L, 4), \
            f(R, L, 4)
    return (A + 1j * f(D_, 4)).astype(np.complex64), c(R, L, 4), c(R, L, 4)


@pytest.mark.parametrize("kind", ["grouped", "static", "complex_A",
                                  "complex_ABC"])
def test_grouped_static_complex_match_jax_ref(kind):
    rng = np.random.default_rng(11)
    R, L = 2, 40
    A, B, C = _weights(rng, kind, R, L)
    u = rng.standard_normal((R, L, D_)).astype(np.float32)
    dl = (0.5 * rng.standard_normal((R, L, D_))).astype(np.float32)
    Dv = rng.standard_normal(D_).astype(np.float32)
    z = rng.standard_normal((R, L, D_)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(D_)).astype(np.float32)
    want_y, want_last = j_selective_scan_ref(
        *map(jnp.asarray, (u, dl, A, B, C)), D=jnp.asarray(Dv),
        z=jnp.asarray(z), delta_bias=jnp.asarray(bias), delta_softplus=True,
        return_last_state=True)
    args = [torch.from_numpy(x) for x in (u, dl, A, B, C)]
    kw = dict(D=torch.from_numpy(Dv), z=torch.from_numpy(z),
              delta_bias=torch.from_numpy(bias), delta_softplus=True,
              return_last_state=True)
    for name, fn in (("ref", selective_scan_ref),
                     ("chunked", lambda *x, **k: selective_scan_chunked(
                         *x, chunk_size=16, **k)),
                     ("auto", lambda *x, **k: selective_scan(
                         *x, impl="pallas", chunk_size=16, **k))):
        y, last = fn(*args, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   err_msg=name, **F32)
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                                   err_msg=name, **F32)


@pytest.mark.parametrize("bias,act", [(True, "silu"), (False, None)])
def test_causal_conv1d_update_matches_jax(bias, act):
    rng = np.random.default_rng(12)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, state, w, b = f(3, 10), f(3, 4, 10), f(4, 10), f(10)
    b = b if bias else None
    want, want_state = j_conv_update(
        jnp.asarray(x), jnp.asarray(state), jnp.asarray(w),
        None if b is None else jnp.asarray(b), activation=act)
    t_state = torch.from_numpy(state)
    got, got_state = causal_conv1d_update(
        torch.from_numpy(x), t_state, torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))
    assert np.array_equal(t_state.numpy(), state)   # not updated in place


@pytest.mark.parametrize("full", [True, False])
def test_selective_state_update_matches_jax(full):
    rng = np.random.default_rng(13)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    a = dict(state=f(2, D_, N_), x=f(2, D_), dt=f(2, D_, sc=0.5),
             A=-np.exp(f(D_, N_, sc=0.5)), B=f(2, N_), C=f(2, N_))
    kw = dict(D=f(D_), z=f(2, D_), dt_bias=f(D_, sc=0.3)) if full else {}
    want = j_ssu(**{k: jnp.asarray(v) for k, v in {**a, **kw}.items()},
                 dt_softplus=full)
    got = selective_state_update(
        **{k: torch.from_numpy(v) for k, v in {**a, **kw}.items()},
        dt_softplus=full)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("rms,residual,prenorm,fp32", [
    (False, True, True, True), (False, False, False, False),
    (True, True, True, False), (True, False, True, True),
])
def test_fused_norms_match_jax(rms, residual, prenorm, fp32):
    """float32 at 1e-5; bfloat16 x at one bf16 rounding (rtol/atol 1e-2),
    the output and a non-fp32 residual in bfloat16 on both sides."""
    rng = np.random.default_rng(14)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, res, w, b = f(2, 5, 16), f(2, 5, 16), f(16), f(16)
    jfn, tfn = ((j_rms_norm_fn, rms_norm_fn) if rms
                else (j_layer_norm_fn, layer_norm_fn))
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = jfn(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                   jnp.asarray(b), residual=jnp.asarray(res) if residual
                   else None, prenorm=prenorm, residual_in_fp32=fp32,
                   eps=1e-5)
        got = tfn(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                  torch.from_numpy(b), residual=torch.from_numpy(res)
                  if residual else None, prenorm=prenorm,
                  residual_in_fp32=fp32, eps=1e-5)
        want, got = (want, got) if prenorm else ((want,), (got,))
        for g, w_ in zip(got, want):
            assert str(g.dtype)[6:] == str(w_.dtype)
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w_, np.float32), rtol=tol,
                                       atol=tol)
