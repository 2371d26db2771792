"""K8's single-pass kernels' decomposition (``csrc/gated_scan_fwd.cu`` and
``csrc/gated_scan_bwd.cu``, PROJ) vs the JAX package, on the CPU.

The card's K8 cuts the scan into chunks of T steps that run apart, one
block owning all channels of a chunk. The forward: each chunk's xc rows
are projected once (x_dbl = xc x_proj, delta = softplus(xdt dt_proj +
bias)); sweep 1 runs the chunk from zero (its exit the aggregate, with sum
delta); the fold x <- exp(A sum delta) x + agg in chunk order gives each
chunk's entry state; sweep 2 reruns the chunk from its entry with the
outputs (C . x + D xc (+ acc)) (* silu z) and the exact exit state. The
backward: sweep F reruns each chunk from the forward's saved entry state
and forms the adjoint aggregate sum_s P_s C_s dy_s (P_s the chunk's
inclusive prefix decay) and sum delta; the fold in reverse chunk order
from zero gives each chunk's adjoint entry; the walk goes back over the
chunk (g, dp, dA, dD, ddt_raw = (sum dp A + S xc) sigmoid(dt_raw), dbias),
and per step the sums over channels dB, dC and dxdt = ddt_raw dt_proj^T
give dxc = S delta + dy D + dxdt W_dt^T + dB W_B^T + dC W_C^T; each
(row, chunk) tile forms its weight-gradient partials (xc^T [dxdt | dB |
dC], xdt^T ddt_raw), which are added after.

This test runs that decomposition in plain torch, float32, in the kernels'
order of chunks and steps, on the "proj" chain of a MambaV3 layer (the
slice orientation ungated, the reverse one with acc, the forward one with
acc and the gate), and holds each call's output and chunk exit states and
its eight gradients against the JAX package's ``mamba_scan_proj`` (its
Pallas K8 in interpret mode) and ``jax.vjp`` through it; the states against
a per-step JAX scan on JAX's projections (``mamba_scan_proj`` returns none).
Tolerance: the float32 tier, rtol 6e-4 / atol 2e-3, with the absolute part
of the weight gradients (sums over steps and rows) scaled by max(1,
max|JAX|).

CPU time: about 15 s (JAX's three interpret-mode calls and their VJPs at
L = 250, which JAX runs as two chunks of 128).
"""

import numpy as np
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from segmamba_tpu.ops.scan_pallas_proj import mamba_scan_proj as j_proj

B_ROWS, L, E, RANK, N, T = 1, 250, 24, 2, 16, 32
TOL = dict(rtol=6e-4, atol=2e-3)
WEIGHTS = ("x_proj", "dt_proj", "dt_bias", "A", "Dv")
CALLS = (("slice", dict(z=False, acc=False, reverse=False)),
         ("reverse_acc", dict(z=False, acc=True, reverse=True)),
         ("forward_acc_gate", dict(z=True, acc=True, reverse=False)))


def _inputs(seed):
    """float32 operands from numpy: each call's xc, the shared weights, z
    and the output's cotangent."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    seq = lambda: f(B_ROWS, L, E)
    return dict(xc_slice=seq(), xc_reverse_acc=seq(),
                xc_forward_acc_gate=seq(), z=seq(), cot=seq(),
                x_proj=f(E, RANK + 2 * N, sc=0.1), dt_proj=f(RANK, E, sc=0.3),
                dt_bias=f(E, sc=0.5), A=-np.exp(f(E, N)), Dv=f(E))


def _chunks(reverse):
    """Per scan-order chunk, its physical rows in scan order."""
    nc = -(-L // T)
    out = []
    for w in range(nc):
        c = nc - 1 - w if reverse else w
        rows = list(range(c * T, min((c + 1) * T, L)))
        out.append(rows[::-1] if reverse else rows)
    return out


def _project(t, u):
    """A tile's projections from its xc rows u (R, n, E): xdt, B, C and
    dt_raw."""
    x_dbl = u @ t["x_proj"]
    xdt = x_dbl[..., :RANK]
    return (xdt, x_dbl[..., RANK:RANK + N], x_dbl[..., RANK + N:],
            xdt @ t["dt_proj"] + t["dt_bias"])


def _forward(t, xc, z, acc, reverse):
    """Projections per chunk, sweep 1 from zero, the fold in chunk order,
    sweep 2 from each entry. Returns the output (R, L, E) and the chunks'
    exit states (R, nc, N, E) in scan order."""
    A = t["A"]
    tiles = []
    for rows in _chunks(reverse):
        u = xc[:, rows]
        _, B, C, dt_raw = _project(t, u)
        tiles.append((rows, u, F.softplus(dt_raw), B, C))
    zero = torch.zeros(B_ROWS, E, N)
    aggs, sds = [], []
    for rows, u, delta, B, _ in tiles:
        h, sd = zero, torch.zeros(B_ROWS, E, 1)
        for s in range(len(rows)):
            dl = delta[:, s, :, None]
            h = torch.exp(dl * A) * h + dl * u[:, s, :, None] * B[:, s, None]
            sd = sd + dl
        aggs.append(h)
        sds.append(sd)
    entry = [zero]
    for w in range(1, len(tiles)):
        entry.append(torch.exp(A * sds[w - 1]) * entry[w - 1] + aggs[w - 1])
    out, exits = torch.zeros(B_ROWS, L, E), []
    for (rows, u, delta, B, C), x in zip(tiles, entry):
        for s, row in enumerate(rows):
            dl = delta[:, s, :, None]
            x = torch.exp(dl * A) * x + dl * u[:, s, :, None] * B[:, s, None]
            y = (x * C[:, s, None]).sum(-1) + t["Dv"] * u[:, s]
            if acc is not None:
                y = y + acc[:, row]
            if z is not None:
                y = y * F.silu(z[:, row])
            out[:, row] = y
        exits.append(x)
    return out, torch.stack(exits, 1).transpose(2, 3)


def _backward(t, xc, z, acc, dout, exits, reverse):
    """Sweep F per chunk from the saved entry states, the reverse fold from
    zero, the walk and each tile's epilogue; the tiles' weight partials
    added after. Returns the gradients of (xc, x_proj, dt_proj, dt_bias, A,
    Dv, z, acc), None where absent."""
    A, Dv = t["A"], t["Dv"]
    Wdt, WB, WC = (t["x_proj"][:, :RANK], t["x_proj"][:, RANK:RANK + N],
                   t["x_proj"][:, RANK + N:])
    chunks = _chunks(reverse)
    nc = len(chunks)
    exits = exits.transpose(2, 3)
    zero = torch.zeros(B_ROWS, E, N)
    dz = torch.zeros(B_ROWS, L, E) if z is not None else None
    tiles, aggs, sds = [], [], []
    for w, rows in enumerate(chunks):
        u = xc[:, rows]
        xdt, B, C, dt_raw = _project(t, u)
        delta = F.softplus(dt_raw)
        g_out = dout[:, rows]
        if z is not None:
            zz = z[:, rows]
            dy = g_out * F.silu(zz)
        else:
            dy = g_out
        x = exits[:, w - 1] if w > 0 else zero
        xs, P, h, sd = [x], torch.ones(B_ROWS, E, N), zero, 0.0
        for s, row in enumerate(rows):
            dl = delta[:, s, :, None]
            a = torch.exp(dl * A)
            x = a * x + dl * u[:, s, :, None] * B[:, s, None]
            P = P * a
            h = h + P * C[:, s, None] * dy[:, s, :, None]
            sd = sd + dl
            xs.append(x)
            if z is not None:   # dz from the gate's input, ytot
                ytot = (x * C[:, s, None]).sum(-1) + Dv * u[:, s]
                if acc is not None:
                    ytot = ytot + acc[:, row]
                sig = torch.sigmoid(zz[:, s])
                dz[:, row] = g_out[:, s] * ytot * (
                    sig + zz[:, s] * sig * (1 - sig))
        tiles.append((rows, u, xdt, B, C, dt_raw, delta, dy, xs))
        aggs.append(h)
        sds.append(sd)
    gin = [None] * nc
    gin[nc - 1] = zero
    for w in range(nc - 2, -1, -1):
        gin[w] = torch.exp(A * sds[w + 1]) * gin[w + 1] + aggs[w + 1]
    dxc = torch.zeros(B_ROWS, L, E)
    parts = []
    for w, (rows, u, xdt, B, C, dt_raw, delta, dy, xs) in enumerate(tiles):
        g = gin[w]
        red, dA, dbias, dD = [], torch.zeros(E, N), torch.zeros(E), \
            torch.zeros(E)
        ddts = torch.zeros(B_ROWS, len(rows), E)
        for s in range(len(rows) - 1, -1, -1):
            dl = delta[:, s, :, None]
            a = torch.exp(dl * A)
            gn = C[:, s, None] * dy[:, s, :, None] + g
            dp = gn * (a * xs[s])
            g = a * gn
            S = (gn * B[:, s, None]).sum(-1)
            ddt = ((dp * A).sum(-1) + S * u[:, s]) * torch.sigmoid(
                dt_raw[:, s])
            dB = (gn * (dl * u[:, s, :, None])).sum(1)
            dC = (xs[s + 1] * dy[:, s, :, None]).sum(1)
            dxdt = ddt @ t["dt_proj"].T
            dxc[:, rows[s]] = (S * delta[:, s] + dy[:, s] * Dv + dxdt @ Wdt.T
                               + dB @ WB.T + dC @ WC.T)
            red.insert(0, torch.cat([dxdt, dB, dC], -1))
            ddts[:, s] = ddt
            dA = dA + (dp * dl).sum(0)
            dbias = dbias + ddt.sum(0)
            dD = dD + (dy[:, s] * u[:, s]).sum(0)
        red = torch.stack(red, 1)   # (R, n, RANK + 2 N)
        parts.append((torch.einsum("rse,rsc->ec", u, red),
                      torch.einsum("rsk,rse->ke", xdt, ddts), dbias, dA, dD))
    dW, ddtp, dbias, dA, dD = (sum(p[i] for p in parts) for i in range(5))
    dacc = None if acc is None else (dout * F.silu(z) if z is not None
                                     else dout.clone())
    return dict(xc=dxc, x_proj=dW, dt_proj=ddtp, dt_bias=dbias, A=dA, Dv=dD,
                z=dz, acc=dacc)


@jax.jit
def _jax_states(xc, x_proj, dt_proj, dt_bias, A):
    """Every step's state (L, R, E, N) of the scan over xc (time order as
    given), on JAX's projections."""
    x_dbl = xc @ x_proj
    delta = jax.nn.softplus(x_dbl[..., :RANK] @ dt_proj + dt_bias)
    B, u = x_dbl[..., RANK:RANK + N], xc

    def step(x, s):
        dl, us, bs = s
        x = jnp.exp(dl[..., None] * A) * x + (dl * us)[..., None] * bs[:, None]
        return x, x

    seq = (jnp.swapaxes(delta, 0, 1), jnp.swapaxes(u, 0, 1),
           jnp.swapaxes(B, 0, 1))
    return jax.lax.scan(step, jnp.zeros((B_ROWS, E, N)), seq)[1]


def _check_states(name, got, a, xc, reverse):
    """The kernels' chunk exit states (R, nc, N, E) against the JAX scan's
    states at each scan-order chunk's last step."""
    seq = xc[:, ::-1] if reverse else xc
    st = np.asarray(_jax_states(jnp.asarray(np.ascontiguousarray(seq)),
                                *(jnp.asarray(a[k]) for k in WEIGHTS[:4])))
    ends = [min((w + 1) * T, L) - 1 for w in range(-(-L // T))]
    if reverse:   # scan step of physical row c T, chunk c = nc - 1 - w
        nc = len(ends)
        ends = [L - 1 - (nc - 1 - w) * T for w in range(nc)]
    want = np.stack([st[i] for i in ends], 1).swapaxes(2, 3)
    np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


def test_proj_chunk_decomposition_matches_jax():
    a = _inputs(12)
    t = {k: torch.from_numpy(a[k]) for k in WEIGHTS}
    jw = [jnp.asarray(a[k]) for k in WEIGHTS]
    # forward through the chain, each call against JAX's K8 with its VJP
    acc, jacc, saved = None, None, []
    for name, flags in CALLS:
        xc = torch.from_numpy(a[f"xc_{name}"])
        z = torch.from_numpy(a["z"]) if flags["z"] else None
        out, exits = _forward(t, xc, z, acc if flags["acc"] else None,
                              flags["reverse"])

        def call(xc_, *rest, flags=flags):
            *w, z_, acc_ = rest
            return j_proj(xc_, *w, z=z_ if flags["z"] else None,
                          acc=acc_ if flags["acc"] else None,
                          reverse=flags["reverse"])

        jz = jnp.asarray(a["z"])
        jacc_in = jacc if flags["acc"] else jnp.zeros((B_ROWS, L, E))
        want, vjp = jax.vjp(call, jnp.asarray(a[f"xc_{name}"]), *jw, jz,
                            jacc_in)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   err_msg=f"{name} out", **TOL)
        _check_states(f"{name} states", exits, a, a[f"xc_{name}"],
                      flags["reverse"])
        saved.append((name, flags, xc, z, acc if flags["acc"] else None,
                      exits, vjp))
        acc, jacc = out, want
    # backward through the chain, the last call first
    dout = torch.from_numpy(a["cot"])
    for name, flags, xc, z, acc_in, exits, vjp in saved[::-1]:
        got = _backward(t, xc, z, acc_in, dout, exits, flags["reverse"])
        want = dict(zip(("xc",) + WEIGHTS + ("z", "acc"),
                        vjp(jnp.asarray(dout.numpy()))))
        for k in ("xc",) + WEIGHTS + ("z", "acc"):
            if got[k] is None:
                continue
            w = np.asarray(want[k])
            tol = dict(TOL)
            if k in WEIGHTS:
                tol["atol"] = TOL["atol"] * max(1.0, float(np.abs(w).max()))
            assert got[k].shape == w.shape, (name, k)
            np.testing.assert_allclose(got[k].numpy(), w,
                                       err_msg=f"{name} d{k}", **tol)
        dout = got["acc"]   # the gradient of the call before's output
