"""The port's sequence-parallel scan against the JAX package, on the CPU.

``segmamba_tpu_torch.ops.scan_sharded`` runs on 2 and 4 spawned ranks
joined by gloo (``parallel.multihost.launch``: one world per size, every
case in it; the ranks run ``parallel.workers.sharded_op_cases`` and import
no JAX). Each case's whole output and gradients (the sequences' gathered,
the parameters' summed over the ranks) are held against
``segmamba_tpu.ops.scan_sharded`` on a ("seq",) mesh of the same size
(``impl="chunked"``, 8 virtual CPU devices):

- ``selective_scan_sharded`` with D, z and delta bias, and with none of
  them; ``mamba_inner_sharded`` forward and reverse (the flip
  orientation); gradients by ``jax.vjp`` with the same cotangent;
- the conv halo: the sharded conv against JAX's unsharded conv in both
  scan orders, and the first shard in scan order (rank 0, or the last rank
  under ``reverse``) against the conv of that shard alone (a zero halo);
- the chunked fix-up ``fixup`` against its plain 4-D einsum, forward and
  gradients, with the chunk small enough to cut L several times.

Tolerances: outputs at the float32 tier (rtol 6e-4 / atol 2e-3);
gradients at rtol 2e-3 / atol 1e-2 x each tensor's max |grad|.

CPU time: about 15 s (two spawned worlds, small JAX compiles).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.ops.causal_conv1d import causal_conv1d as j_conv
from segmamba_tpu.ops.scan_sharded import (
    mamba_inner_sharded as j_inner,
    selective_scan_sharded as j_scan,
)
from segmamba_tpu.parallel import make_mesh as j_make_mesh
from segmamba_tpu_torch.ops import scan_sharded
from segmamba_tpu_torch.parallel import workers
from segmamba_tpu_torch.parallel.multihost import launch

OUT_TOL = dict(rtol=6e-4, atol=2e-3)
B, L, D, N = 2, 32, 6, 4
DIN, R = 8, 2


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    scan_full = dict(u=f(B, L, D), delta=f(B, L, D, sc=0.3),
                     A=-np.exp(f(D, N, sc=0.3)), B=f(B, L, N), C=f(B, L, N),
                     D=f(D), z=f(B, L, D), delta_bias=f(D, sc=0.1))
    scan_bare = {k: scan_full[k] for k in ("u", "B", "C")}
    scan_bare.update(delta=np.abs(scan_full["delta"]),
                     A=-np.ones((D, N), np.float32))
    inner = dict(xz=f(B, L, 2 * DIN), conv_weight=f(4, DIN, sc=0.3),
                 conv_bias=f(DIN, sc=0.1), x_proj=f(DIN, R + 2 * N, sc=0.3),
                 dt_proj=f(R, DIN, sc=0.3), dt_bias=f(DIN, sc=0.1),
                 A=-np.exp(f(DIN, N, sc=0.3)), D_skip=f(DIN))
    conv = dict(x=f(B, L, 5), weight=f(4, 5, sc=0.5), bias=f(5, sc=0.1))
    cases = {
        "scan": dict(op="scan", inputs=scan_full,
                     kw=dict(delta_softplus=True), cot=f(B, L, D)),
        "scan_no_optionals": dict(op="scan", inputs=scan_bare, kw={},
                                  cot=f(B, L, D)),
        "inner": dict(op="inner", inputs=inner,
                      kw=dict(d_state=N, reverse=False), cot=f(B, L, DIN)),
        "inner_reverse": dict(op="inner", inputs=inner,
                              kw=dict(d_state=N, reverse=True),
                              cot=f(B, L, DIN)),
        "conv": dict(op="conv", inputs=conv, kw=dict(reverse=False),
                     cot=f(B, L, 5)),
        "conv_reverse": dict(op="conv", inputs=conv, kw=dict(reverse=True),
                             cot=f(B, L, 5)),
    }
    return cases


CASES = _inputs()
NAMES = list(CASES)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def world(request):
    """(rank count, the ranks' results by case name): one spawned world."""
    n = request.param
    res = launch(workers.sharded_op_cases, n, [CASES[k] for k in NAMES],
                 device="cpu", timeout_s=300)
    for r in res[1:]:   # every rank gathers the same whole arrays
        for a, b in zip(res[0], r):
            np.testing.assert_array_equal(a["out"], b["out"])
    return n, dict(zip(NAMES, res[0]))


def _jax_fn(case, mesh):
    kw = case["kw"]
    if case["op"] == "scan":
        return lambda a: j_scan(
            a["u"], a["delta"], a["A"], a["B"], a["C"], a.get("D"),
            a.get("z"), a.get("delta_bias"), mesh=mesh, impl="chunked",
            **kw)
    if case["op"] == "inner":
        return lambda a: j_inner(
            a["xz"], a["conv_weight"], a["conv_bias"], a["x_proj"],
            a["dt_proj"], a["dt_bias"], a["A"], a["D_skip"], mesh=mesh,
            impl="chunked", **kw)
    if kw["reverse"]:   # the conv alone: JAX's unsharded conv, flipped
        return lambda a: jnp.flip(j_conv(jnp.flip(a["x"], 1), a["weight"],
                                         a["bias"], activation="silu"), 1)
    return lambda a: j_conv(a["x"], a["weight"], a["bias"],
                            activation="silu")


def _grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-2 * scale,
                               err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_op_matches_jax(world, name):
    n, results = world
    case, got = CASES[name], results[name]
    mesh = j_make_mesh(n, ("seq",))
    fn = _jax_fn(case, mesh)

    def out_and_grads(args, cot):   # jitted: the eager shard_map VJP trips
        out, vjp = jax.vjp(fn, args)   # an XLA sharding assertion on the CPU
        return out, vjp(cot)[0]

    args = {k: jnp.asarray(v) for k, v in case["inputs"].items()}
    out, grads = jax.jit(out_and_grads)(args, jnp.asarray(case["cot"]))
    np.testing.assert_allclose(got["out"], np.asarray(out), **OUT_TOL)
    assert set(got["grads"]) == set(grads)
    for k, g in grads.items():
        _grad_close(got["grads"][k], np.asarray(g), f"{name} d{k}")


@pytest.mark.parametrize("name", ["conv", "conv_reverse"])
def test_halo_at_first_shard(world, name):
    """The first shard in scan order sees a zero halo: its output is the
    conv of that shard alone."""
    n, results = world
    case = CASES[name]
    a = case["inputs"]
    L_loc = L // n
    reverse = case["kw"]["reverse"]
    sl = slice(L - L_loc, L) if reverse else slice(0, L_loc)
    x = jnp.asarray(a["x"][:, sl])
    if reverse:
        want = jnp.flip(j_conv(jnp.flip(x, 1), a["weight"], a["bias"],
                               activation="silu"), 1)
    else:
        want = j_conv(x, a["weight"], a["bias"], activation="silu")
    np.testing.assert_allclose(results[name]["out"][:, sl],
                               np.asarray(want), **OUT_TOL)


def test_fixup_chunks_match_plain_einsum(monkeypatch):
    rng = np.random.default_rng(4)
    b, l, d, n = 2, 40, 6, 4
    monkeypatch.setattr(scan_sharded, "FIXUP_ELEMS", 7 * b * d * n)
    assert len(scan_sharded._fixup_chunks(l, b, d, n)) == 6
    t = lambda *s, sc=1.0: torch.tensor(
        (sc * rng.standard_normal(s)).astype(np.float32), requires_grad=True)
    C, A, entry = t(b, l, n), t(d, n), t(b, d, n)
    cd = torch.cumsum(torch.nn.functional.softplus(
        torch.tensor(rng.standard_normal((b, l, d)).astype(np.float32))),
        1).requires_grad_()
    A.data = -A.data.exp()
    dy = torch.tensor(rng.standard_normal((b, l, d)).astype(np.float32))
    got = scan_sharded.fixup(C, cd, A, entry)
    g_got = torch.autograd.grad(got, (C, cd, A, entry), dy)
    want = scan_sharded.fixup_ref(C, cd, A, entry)
    g_want = torch.autograd.grad(want, (C, cd, A, entry), dy)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for name, g, w in zip(("dC", "dcd", "dA", "dentry"), g_got, g_want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
