"""The backward scan kernel's decomposition (``csrc/gated_scan_bwd.cu``) vs
the JAX package, on the CPU.

The card's kernel splits the gated scan's backward into chunks that run
apart: a forward sweep over each chunk from the forward's saved entry state
gives the chunk's adjoint aggregate h = sum_s P_s C_s dy_s (P_s the
inclusive prefix product of the decays a) and its sum of delta; a fold in
reverse scan order, g <- exp(A sum delta) g + h, gives every chunk's adjoint
entry; a walk over each chunk from its entry gives the gradients. This test
runs that decomposition in plain torch (float32, the kernel's order of
chunks and steps, with and without REVERSE, gated with acc, ragged L) and
holds its nine gradients against ``jax.grad`` through the JAX package's
``mamba_scan_fused_dir``, whose custom VJP runs the Pallas K3 in interpret
mode. Tolerance: the float32 tier of ``chip_smoke.py`` (rtol 6e-4, atol
2e-3). A second case folds with the K6 seed (a nonzero adjoint of the last
state) against autograd through the plain forward.

CPU time: about 15 s (two JAX grad compiles of the Pallas K3 in
interpret mode over a 421-step scan).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.ops.scan_pallas_dir import mamba_scan_fused_dir as j_dir
from segmamba_tpu_torch.ops import scan_dir

R, L, D, N, T = 2, 3 * 128 + 37, 8, 16, 128
TOL = dict(rtol=6e-4, atol=2e-3)
NAMES = ("u", "dt", "z", "acc", "A", "B", "C", "D", "bias")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    # small decays (|A| ~ 0.14, delta ~ 0.1), so that a chunk's carry
    # reaches well into the chunks before it and the fold matters
    return dict(u=f(R, L, D), dt=f(R, L, D, sc=0.5), z=f(R, L, D),
                acc=f(R, L, D), A=-np.exp(f(D, N) - 2.0), B=f(R, L, N),
                C=f(R, L, N), D=f(D), bias=f(D, sc=0.3) - 2.5,
                dout=f(R, L, D))


def _chunks(reverse):
    """Each chunk's physical rows in scan order, chunks in scan order:
    multiples of T on the original layout; with REVERSE the chunks and the
    steps inside them run mirrored, so the ragged chunk comes first."""
    nc = -(-L // T)
    out = []
    for w in range(nc):
        c = nc - 1 - w if reverse else w
        rows = list(range(c * T, min(L, c * T + T)))
        out.append(rows[::-1] if reverse else rows)
    return out


def _decomposed_grads(a, reverse, gate=True, acc=True, dlast=None):
    """The kernel's algorithm in plain torch: sweep F per chunk, the reverse
    fold of the aggregates, the walk per chunk. Returns the nine gradients
    (None where the input is not used) as numpy arrays."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    A = t["A"]                                             # (D, N)
    delta = torch.nn.functional.softplus(t["dt"] + t["bias"])
    sig = torch.sigmoid(t["dt"] + t["bias"])
    u, B, C, go = t["u"], t["B"], t["C"], t["dout"]
    if gate:
        sz = torch.sigmoid(t["z"])
        dy = go * t["z"] * sz
        dzf = go * sz * (1 + t["z"] * (1 - sz))
    else:
        dy = go
    yw = t["D"] * u + (t["acc"] if acc else 0.0)
    _, states = scan_dir.mamba_scan_fused_dir_ref(
        u, t["dt"], t["z"] if gate else None, A, B, C, t["D"], t["bias"],
        acc=t["acc"] if acc else None, gate=gate, reverse=reverse,
        chunk_size=T, return_states=True)                  # (R, nc, N, D)
    chunks = _chunks(reverse)
    nc = len(chunks)
    step = lambda s: (delta[:, s, :, None], u[:, s, :, None],
                      B[:, s, None, :], C[:, s, None, :], dy[:, s, :, None])

    # sweep F: from each chunk's saved entry state, its aggregate and sum
    # of delta (and dz, from the rebuilt x)
    dz = torch.zeros(R, L, D)
    xs, aggs, sds = [], [], []
    for w, rows in enumerate(chunks):
        x = (states[:, w - 1].transpose(1, 2) if w > 0
             else torch.zeros(R, D, N))                    # (R, D, N)
        P, h, sd, xw = torch.ones(R, D, N), torch.zeros(R, D, N), 0.0, []
        for s in rows:
            dl, uu, b, c, dys = step(s)
            an = torch.exp(dl * A)
            xw.append(x)                                   # x before s
            x = an * x + dl * uu * b
            P = P * an
            h = h + P * c * dys
            sd = sd + dl
            if gate:
                dz[:, s] = dzf[:, s] * ((c * x).sum(-1) + yw[:, s])
        xs.append(xw)
        aggs.append(h)
        sds.append(sd)

    # the fold in reverse scan order, from the seed of the last scan chunk
    entry = [None] * nc
    entry[nc - 1] = (torch.zeros(R, D, N) if dlast is None
                     else torch.from_numpy(dlast))
    for w in range(nc - 2, -1, -1):
        entry[w] = torch.exp(A * sds[w + 1]) * entry[w + 1] + aggs[w + 1]

    # the walks
    g_u, g_dt = torch.zeros(R, L, D), torch.zeros(R, L, D)
    dB, dC = torch.zeros(R, L, N), torch.zeros(R, L, N)
    dA, dD, dbias = torch.zeros(D, N), torch.zeros(D), torch.zeros(D)
    for w, rows in enumerate(chunks):
        g = entry[w]
        for k in range(len(rows) - 1, -1, -1):
            s = rows[k]
            dl, uu, b, c, dys = step(s)
            an = torch.exp(dl * A)
            xprev = xs[w][k]
            x = an * xprev + dl * uu * b
            gn = c * dys + g
            dp = gn * an * xprev
            dA += (dp * dl).sum(0)
            S = (gn * b).sum(-1)
            ddelta = (dp * A).sum(-1) + S * u[:, s]
            g_u[:, s] = S * delta[:, s] + dy[:, s] * t["D"]
            g_dt[:, s] = ddelta * sig[:, s]
            dD += (dy[:, s] * u[:, s]).sum(0)
            dbias += g_dt[:, s].sum(0)
            dB[:, s] = (gn * dl * uu).sum(1)
            dC[:, s] = (x * dys).sum(1)
            g = an * gn
    out = dict(u=g_u, dt=g_dt, z=dz if gate else None,
               acc=dy if acc else None, A=dA, B=dB, C=dC, D=dD, bias=dbias)
    return {k: None if v is None else v.numpy() for k, v in out.items()}


def _jax_grads(a, reverse):
    """jax.grad through the JAX dir entry (shared parameters broadcast to
    rows inside the function, so their gradients sum over rows)."""
    def loss(*args):
        v = dict(zip(NAMES, args))
        rows = {k: jnp.broadcast_to(v[k], (R,) + v[k].shape)
                for k in ("A", "D", "bias")}
        out = j_dir(v["u"], v["dt"], v["z"], rows["A"], v["B"], v["C"],
                    rows["D"], rows["bias"], acc=v["acc"], gate=True,
                    reverse=reverse)
        return jnp.sum(out * jnp.asarray(a["dout"]))

    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(
        *(jnp.asarray(a[n]) for n in NAMES))
    return dict(zip(NAMES, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("reverse", [False, True])
def test_chunk_decomposition_matches_jax(reverse):
    a = _inputs(7 + reverse)
    got = _decomposed_grads(a, reverse)
    want = _jax_grads(a, reverse)
    for n in NAMES:
        assert got[n].shape == a[n].shape, n
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


def test_chunk_decomposition_folds_the_last_state_seed():
    """K6's mode: ungated, no acc, the adjoint of the last state as the
    seed of the fold; against autograd through the plain forward."""
    a = _inputs(11)
    dlast = np.random.default_rng(12).standard_normal((R, D, N)).astype(
        np.float32)
    got = _decomposed_grads(a, reverse=False, gate=False, acc=False,
                            dlast=dlast)
    t = {n: torch.from_numpy(a[n]).requires_grad_()
         for n in ("u", "dt", "A", "B", "C", "D", "bias")}
    out, states = scan_dir.mamba_scan_fused_dir_ref(
        t["u"], t["dt"], None, t["A"], t["B"], t["C"], t["D"], t["bias"],
        gate=False, chunk_size=T, return_states=True)
    last = states[:, -1].transpose(1, 2)                   # (R, D, N)
    torch.autograd.backward((out, last), (torch.from_numpy(a["dout"]),
                                          torch.from_numpy(dlast)))
    for n, leaf in t.items():
        np.testing.assert_allclose(got[n], leaf.grad.numpy(), err_msg=n,
                                   **TOL)
