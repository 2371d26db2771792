"""The port's matrix-unit scan K7 (``scan_mxu``) vs the JAX package, on the
CPU.

JAX's ``selective_scan_mxu`` runs its Pallas kernels in interpret mode here,
as ``tests/test_scan_mxu.py`` runs them; the port runs K7's plain version
(the same ratio-form arithmetic with its per-unit guard). Inputs come from
``numpy.random.default_rng(seed)`` (``make_inputs`` of
``tests/test_selective_scan.py``) and go to both sides.

- Benign inputs (A scaled so that JAX's global guard bound stays below
  ``MAX_BLOCK_DROP``: both sides take the ratio form everywhere): y and the
  last state at rtol 1e-4 / atol 1e-5 (only the order of the sums
  differs), L in {8, 37, 128, 260, 1024} (37: one sub-block of 40 steps),
  the multi-chunk carry at L = 384; gradients with and without a gradient
  of the last state at (2, 70, 10, 4) at JAX's own tier, rtol 2e-3 / atol
  2e-3.
- Inputs that trip the guard (delta + 40): JAX runs its K6 fallback, the
  port K7 with every unit in the step form; at the f32 tier rtol 6e-4 /
  atol 2e-3, gradients finite. A mixed input (some sub-blocks trip) vs
  JAX's ``selective_scan_ref``.
- ``guarded=False`` against JAX's unguarded kernel and the guarded form.
- The dispatcher: ``impl="mxu"`` reaches K7, and grouped, static or
  complex B/C go to the chunked core first, as in JAX.
- Model level in float32, ``scan_impl="mxu"`` on both sides: the tiny LM
  of ``test_torch_port_lm.py`` (the port's seeded weights bridged to JAX
  by ``convert_lm_state_dict``; forward, prefill and its caches, rtol 1e-4
  / atol 1e-5) and the tiny SegMamba of ``test_torch_port_model.py`` on a
  16^3 input (stage-0 L = 512; rtol 2e-3 / atol 1e-2 x max|JAX|, that
  file's tier).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.models import SegMamba as JSegMamba
from segmamba_tpu.models.mamba_lm import MambaLMHeadModel as JLM
from segmamba_tpu.ops import selective_scan as j_selective_scan
from segmamba_tpu.ops.scan_pallas_mxu import (
    MAX_BLOCK_DROP as J_MAX_BLOCK_DROP,
    _block_drop,
    selective_scan_mxu as j_selective_scan_mxu,
)
from segmamba_tpu.ops.selective_scan import (
    selective_scan_ref as j_selective_scan_ref,
)
from segmamba_tpu.utils.hf import convert_lm_state_dict as j_convert
from segmamba_tpu.utils.torch_convert import convert_segmamba_state_dict
from segmamba_tpu_torch.models import MambaLMHeadModel, SegMamba
from segmamba_tpu_torch.ops import scan_mxu
from segmamba_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_chunked,
)

from test_selective_scan import make_inputs

BENIGN = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-3)
F32 = dict(rtol=6e-4, atol=2e-3)
ARGS = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")


def _inputs(seed, batch, L, dim, n, a_scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    a = dict(zip(ARGS, make_inputs(rng, batch, L, dim, n, np.float32)))
    a["A"] = a["A"] * np.float32(a_scale)
    if shift:
        a["delta"] = np.abs(a["delta"]) + np.float32(shift)
    return a, rng


def _jax(a, **kw):
    return j_selective_scan_mxu(**{k: jnp.asarray(v) for k, v in a.items()},
                                delta_softplus=True, return_last_state=True,
                                **kw)


def _port(a, **kw):
    return scan_mxu.selective_scan_mxu(
        **{k: torch.from_numpy(v) for k, v in a.items()},
        delta_softplus=True, return_last_state=True, **kw)


def _jax_drop(a, S):
    """JAX's guard bound on the softplus deltas (L padded as JAX pads)."""
    d = jax.nn.softplus(jnp.asarray(a["delta"]) + jnp.asarray(
        a["delta_bias"]))
    pad = (-d.shape[1]) % S
    d = jnp.pad(d, ((0, 0), (0, pad), (0, 0)))
    return float(_block_drop(d, jnp.asarray(a["A"].T), S))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


@pytest.mark.parametrize("L", [8, 37, 128, 260, 1024])
def test_benign_forward_matches_jax(L):
    a, _ = _inputs(0, 2, L, 12, 8, a_scale=0.2)
    T, S = scan_mxu._geometry(L)
    assert _jax_drop(a, S) < J_MAX_BLOCK_DROP
    want_y, want_last = _jax(a)
    with scan_mxu.tally() as t:
        y, last = _port(a)
    assert t.step == 0 and t.ratio == 2 * 12 * 8 * -(-L // S)
    _close(y, want_y, **BENIGN)
    _close(last, want_last, **BENIGN)


def test_multichunk_carry_matches_jax():
    a, _ = _inputs(7, 1, 384, 8, 4, a_scale=0.2)
    assert _jax_drop(a, 16) < J_MAX_BLOCK_DROP
    want_y, want_last = _jax(a)
    y, last = _port(a)
    _close(y, want_y, **BENIGN)
    _close(last, want_last, **BENIGN)


def _grads(fwd, a, cot_y, cot_x, to, names=ARGS):
    """Gradients of sum(y cot_y) (+ sum(last cot_x)) w.r.t. ``names``."""
    if to == "jax":
        def loss(*args):
            y, last = fwd(dict(a, **dict(zip(names, args))))
            val = jnp.sum(y * cot_y)
            return val if cot_x is None else val + jnp.sum(last * cot_x)
        return [np.asarray(g) for g in jax.grad(
            loss, argnums=tuple(range(len(names))))(
                *(jnp.asarray(a[k]) for k in names))]
    leaves = {k: torch.from_numpy(a[k]).requires_grad_() for k in names}
    y, last = fwd({**{k: torch.from_numpy(v) for k, v in a.items()},
                   **leaves})
    loss = (y * torch.from_numpy(cot_y)).sum()
    if cot_x is not None:
        loss = loss + (last * torch.from_numpy(cot_x)).sum()
    loss.backward()
    return [leaves[k].grad.numpy() for k in names]


def _jfwd(**kw):
    return lambda a: j_selective_scan_mxu(**a, delta_softplus=True,
                                          return_last_state=True, **kw)


def _tfwd(**kw):
    return lambda a: scan_mxu.selective_scan_mxu(
        **a, delta_softplus=True, return_last_state=True, **kw)


@pytest.mark.parametrize("use_last", [False, True])
def test_benign_gradients_match_jax(use_last):
    a, rng = _inputs(2, 2, 70, 10, 4, a_scale=0.2)
    assert _jax_drop(a, 16) < J_MAX_BLOCK_DROP
    cot_y = rng.standard_normal((2, 70, 10)).astype(np.float32)
    cot_x = (rng.standard_normal((2, 10, 4)).astype(np.float32)
             if use_last else None)
    want = _grads(_jfwd(), a, cot_y, cot_x, "jax")
    got = _grads(_tfwd(), a, cot_y, cot_x, "torch")
    for name, g, w in zip(ARGS, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD)


def test_tripped_guard_matches_jax_fallback():
    """Every unit trips: JAX takes K6, the port K7's step form."""
    a, rng = _inputs(8, 1, 256, 8, 4, shift=40.0)
    drop = _jax_drop(a, 16)
    assert drop > J_MAX_BLOCK_DROP
    d = torch.nn.functional.softplus(torch.from_numpy(a["delta"] + a[
        "delta_bias"]))
    assert scan_mxu.block_drop(d, torch.from_numpy(a["A"]), 16) == \
        pytest.approx(drop, rel=1e-6)
    want_y, want_last = _jax(a)
    with scan_mxu.tally() as t:
        y, last = _port(a)
    assert t.ratio == 0 and t.step == 8 * 4 * 16
    assert torch.isfinite(y).all()
    _close(y, want_y, **F32)
    _close(last, want_last, **F32)
    cot_y = rng.standard_normal((1, 256, 8)).astype(np.float32)
    cot_x = rng.standard_normal((1, 8, 4)).astype(np.float32)
    names = ("u", "delta", "A", "B", "C")
    want = _grads(_jfwd(), a, cot_y, cot_x, "jax", names)
    got = _grads(_tfwd(), a, cot_y, cot_x, "torch", names)
    for name, g, w in zip(names, got, want):
        assert np.isfinite(g).all(), name
        atol = GRAD["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=GRAD["rtol"], atol=atol,
                                   err_msg=name)


def test_mixed_guard_matches_jax_ref():
    """Some sub-blocks trip (large deltas in part of the sequence and in
    some channels), the rest take the ratio form."""
    a, rng = _inputs(4, 2, 300, 12, 8)
    a["delta"][:, 100:180, ::3] += np.float32(6.0)
    with scan_mxu.tally() as t:
        y, last = _port(a)
    assert t.ratio > 0 and t.step > 0
    want_y, want_last = j_selective_scan_ref(
        **{k: jnp.asarray(v) for k, v in a.items()}, delta_softplus=True,
        return_last_state=True)
    _close(y, want_y, **F32)
    _close(last, want_last, **F32)
    cot_y = rng.standard_normal((2, 300, 12)).astype(np.float32)
    cot_x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    want = _grads(lambda b: j_selective_scan_ref(
        **b, delta_softplus=True, return_last_state=True), a, cot_y, cot_x,
        "jax")
    got = _grads(_tfwd(), a, cot_y, cot_x, "torch")
    for name, g, w in zip(ARGS, got, want):
        assert np.isfinite(g).all(), name
        atol = GRAD["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=GRAD["rtol"], atol=atol,
                                   err_msg=name)


def test_unguarded_matches_jax_and_guarded():
    a, _ = _inputs(9, 1, 256, 8, 4, a_scale=0.2)
    want_y, want_last = _jax(a, guarded=False)
    y, last = _port(a, guarded=False)
    _close(y, want_y, **BENIGN)
    _close(last, want_last, **BENIGN)
    y_g, last_g = _port(a, guarded=True)
    np.testing.assert_allclose(y.numpy(), y_g.numpy(), rtol=1e-5, atol=1e-5)


def test_dispatch_mxu_reaches_k7_and_other_bc_go_chunked():
    a, rng = _inputs(10, 1, 64, 8, 4, a_scale=0.2)
    kw = {k: torch.from_numpy(v) for k, v in a.items()}
    with scan_mxu.tally() as t:
        y = selective_scan(**kw, delta_softplus=True, impl="mxu")
    assert t.ratio == 8 * 4 * 4
    want = j_selective_scan(**{k: jnp.asarray(v) for k, v in a.items()},
                            delta_softplus=True, impl="mxu")
    _close(y, want, **BENIGN)
    # grouped, static and complex B/C: the chunked core (held against JAX
    # in test_torch_port_selective_scan.py), tested before "mxu" as in JAX
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    for B, C in ((f(1, 64, 2, 4), f(1, 64, 2, 4)), (f(8, 4), f(8, 4)),
                 ((f(1, 64, 4) + 1j * f(1, 64, 4)).astype(np.complex64),
                  f(1, 64, 4))):
        kw = {k: torch.from_numpy(v) for k, v in dict(a, B=B, C=C).items()}
        with scan_mxu.tally() as t:
            y = selective_scan(**kw, delta_softplus=True, impl="mxu")
        assert t.ratio == t.step == 0
        want = selective_scan_chunked(**kw, delta_softplus=True)
        assert torch.equal(y, want)


LM = dict(vocab_size=64, d_model=32, n_layer=2, rms_norm=True)


def test_tiny_lm_mxu_matches_jax():
    """Forward logits, prefill hidden states and SSM / conv caches of the
    tiny LM with ``scan_impl="mxu"`` on both sides."""
    tm = MambaLMHeadModel(**LM, scan_impl="mxu",
                          generator=torch.Generator().manual_seed(1)).eval()
    params = j_convert({k: v.numpy() for k, v in tm.state_dict().items()})
    jm = JLM(**LM, scan_impl="mxu")
    ids = np.random.default_rng(0).integers(0, 64, (2, 11))
    want = np.asarray(jm.apply(params, jnp.asarray(ids)))
    jh, jcaches = jm.apply(params, jnp.asarray(ids),
                           method=lambda m, x: m.backbone.prefill(x))
    with torch.no_grad(), scan_mxu.tally() as t:
        got = tm(torch.from_numpy(ids))
        th, tcaches = tm.backbone.prefill(torch.from_numpy(ids))
    assert t.ratio > 0
    tol = dict(rtol=1e-4, atol=1e-5)
    _close(got, want, **tol)
    _close(th, jh, **tol)
    for jc, tc in zip(jcaches, tcaches):
        for k in ("conv", "ssm"):
            _close(tc[k], jc[k], err_msg=k, **tol)


SEG = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
           feat_size=(4, 8, 16, 32), hidden_size=64,
           num_slices_list=(8, 4, 2, 1))


def test_tiny_segmamba_mxu_matches_jax():
    """The tiny SegMamba with ``scan_impl="mxu"`` on both sides (the
    per-direction composition: K7 per direction), 16^3 input."""
    model = SegMamba(generator=torch.Generator().manual_seed(0),
                     scan_impl="mxu", **SEG)
    tree = convert_segmamba_state_dict(model.state_dict(),
                                       depths=SEG["depths"])
    x = np.random.default_rng(0).standard_normal((1, 2, 16, 16, 16)).astype(
        np.float32)
    jm = JSegMamba(scan_impl="mxu", **SEG)
    want = np.moveaxis(np.asarray(jax.jit(jm.apply)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    with torch.no_grad(), scan_mxu.tally() as t:
        got = model(torch.from_numpy(x))
    assert t.ratio > 0
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                               atol=1e-2 * np.abs(want).max())
