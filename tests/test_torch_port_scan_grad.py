"""Gradients of the port's scan ops vs the JAX package, on the CPU.

The port's ``torch.autograd.Function`` (``scan_dir._GatedScan``) behind
``mamba_scan_fused_dir`` / ``mamba_scan_fused``, on CPU tensors (its plain
backward), against ``jax.grad`` through the JAX entry points, whose custom
VJPs run the Pallas backward kernels K3/K4 in interpret mode. The three
flag sets of the dir2 path (flip: reverse, ungated; forward: gate + acc;
slice: the fused gate), shared and per-row parameters, ragged L (300 with
chunks of 128) and a multiple of 128, ragged D (40), N = 16, float32, all
nine gradients. Tolerance rtol 2e-4 / atol 2e-5, the JAX package's own tier
for these gradients (tests/test_scan_dir.py:114).

CPU time: about 15 s with a warm JAX cache (6 JAX grad compiles).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.ops.scan_pallas_dir import mamba_scan_fused_dir as j_dir
from segmamba_tpu.ops.scan_pallas_fused import mamba_scan_fused as j_fused
from segmamba_tpu_torch.ops import scan_dir, scan_fused

N = 16
D = 40
TOL = dict(rtol=2e-4, atol=2e-5)
NAMES = ("u", "dt", "z", "acc", "A", "B", "C", "D", "bias")
FLAGS = {
    "dir_reverse": dict(reverse=True, gate=False, acc=False),
    "dir_gate_acc": dict(reverse=False, gate=True, acc=True),
    "fused": dict(reverse=False, gate=True, acc=False),
}


def _inputs(seed, R, L, per_row):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    ps = (R, D) if per_row else (D,)
    return dict(u=f(R, L, D), dt=f(R, L, D, sc=0.2), z=f(R, L, D),
                acc=f(R, L, D), A=-np.exp(f(*ps, N)), B=f(R, L, N),
                C=f(R, L, N), D=f(*ps), bias=f(*ps, sc=0.3),
                dout=f(R, L, D))


def _used(flags):
    return [n for n in NAMES
            if not (n == "z" and not flags["gate"])
            and not (n == "acc" and not flags["acc"])]


def _jax_grads(name, a, R):
    flags = FLAGS[name]
    used = _used(flags)

    def loss(*args):
        v = dict(zip(used, args))
        if name == "fused":
            out = j_fused(v["u"], v["dt"], v["z"], v["A"], v["B"], v["C"],
                          v["D"], v["bias"])
        else:
            # the JAX dir entry takes per-row parameters: broadcast shared
            # ones inside the function, so their gradients sum over rows
            rows = {k: (jnp.broadcast_to(v[k], (R,) + v[k].shape)
                        if v[k].ndim < nd else v[k])
                    for k, nd in (("A", 3), ("D", 2), ("bias", 2))}
            out = j_dir(v["u"], v["dt"], v.get("z"), rows["A"], v["B"],
                        v["C"], rows["D"], rows["bias"], acc=v.get("acc"),
                        gate=flags["gate"], reverse=flags["reverse"])
        return jnp.sum(out * jnp.asarray(a["dout"]))

    grads = jax.grad(loss, argnums=tuple(range(len(used))))(
        *(jnp.asarray(a[n]) for n in used))
    return dict(zip(used, (np.asarray(g) for g in grads)))


def _port_grads(name, a):
    flags = FLAGS[name]
    used = _used(flags)
    t = {n: torch.from_numpy(a[n]).requires_grad_() for n in used}
    if name == "fused":
        out = scan_fused.mamba_scan_fused(t["u"], t["dt"], t["z"], t["A"],
                                          t["B"], t["C"], t["D"], t["bias"])
    else:
        out = scan_dir.mamba_scan_fused_dir(
            t["u"], t["dt"], t.get("z"), t["A"], t["B"], t["C"], t["D"],
            t["bias"], acc=t.get("acc"), gate=flags["gate"],
            reverse=flags["reverse"])
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(a["dout"]))
    return {n: t[n].grad.numpy() for n in used}


@pytest.mark.parametrize("name,per_row,L", [
    ("dir_reverse", False, 300),
    ("dir_reverse", True, 256),
    ("dir_gate_acc", True, 300),
    ("dir_gate_acc", False, 256),
    ("fused", False, 300),
    ("fused", True, 256),
])
def test_scan_grads_match_jax(name, per_row, L):
    R = 2
    a = _inputs(L + per_row, R, L, per_row)
    want = _jax_grads(name, a, R)
    got = _port_grads(name, a)
    assert set(got) == set(want)
    for n in got:
        assert got[n].shape == a[n].shape, n
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


@pytest.mark.parametrize("name", list(FLAGS))
def test_plain_backward_is_the_functions_cpu_backward(name):
    """``mamba_scan_fused_dir_bwd_ref`` (and the fused one) give exactly the
    gradients the Function's CPU backward hands to autograd."""
    flags = FLAGS[name]
    a = _inputs(3, 2, 300, per_row=False)
    got = _port_grads(name, a)
    t = {n: torch.from_numpy(a[n]) for n in NAMES}
    dout = torch.from_numpy(a["dout"])
    if name == "fused":
        ref = scan_fused.mamba_scan_fused_bwd_ref(
            t["u"], t["dt"], t["z"], t["A"], t["B"], t["C"], t["D"],
            t["bias"], dout)
    else:
        ref = scan_dir.mamba_scan_fused_dir_bwd_ref(
            t["u"], t["dt"], t["z"] if flags["gate"] else None, t["A"],
            t["B"], t["C"], t["D"], t["bias"], dout,
            acc=t["acc"] if flags["acc"] else None, gate=flags["gate"],
            reverse=flags["reverse"])
    ref = dict(zip(NAMES, ref))
    for n in NAMES:
        if n in got:
            assert torch.equal(torch.from_numpy(got[n]), ref[n]), n
        else:
            assert ref[n] is None, n


def test_no_grad_records_nothing():
    """Without grad (``inference_mode``) the wrappers record no graph."""
    a = _inputs(4, 1, 64, per_row=False)
    t = {n: torch.from_numpy(a[n]).requires_grad_() for n in NAMES}
    with torch.inference_mode():
        out = scan_dir.mamba_scan_fused_dir(
            t["u"], t["dt"], t["z"], t["A"], t["B"], t["C"], t["D"],
            t["bias"], acc=t["acc"])
    assert out.grad_fn is None
