"""K7's single-pass kernels' decomposition (``csrc/gated_scan_fwd.cu`` and
``csrc/gated_scan_bwd.cu``, RATIO) vs the JAX package, on the CPU.

The card's K7 splits the ratio-form scan into chunks of T steps that run
apart, each cut into sub-blocks of S steps whose units (row, channel,
state, sub-block) take the ratio form or the step form by the guard (the
serial sum of |delta| over the sub-block, in step order, times |A|, below
``MAX_BLOCK_DROP``). The forward: sweep 1 runs each chunk from zero (its
exit the aggregate), the fold x <- exp(A sum delta) x + agg in chunk order
gives each chunk's entry state, and sweep 2 reruns the chunk from its entry
with the outputs (the kept "rerun" schedule). The backward: sweep F reruns
each chunk from the forward's saved entry state, keeping the ratio form's
running value (x at a sub-block's end) and forming the adjoint aggregate
sum_s P_s C_s dy_s (P_s the chunk's prefix decay: the earlier sub-blocks'
P_end times the step's P, or the step form's product of decays); the fold
in reverse chunk order, from the adjoint of the last state, gives each
chunk's adjoint entry; the walk goes back over each chunk in the ratio
form's upper-triangular sums (gr = P_end g_in at a sub-block's end, gr += P
dx, g = Pinv gr, the carry a g at its start) or the step form's g = dx + a g,
with dp = g (x_{t-1} a_t) = g (P_t v_{t-1}).

This test runs that decomposition in plain torch, float32, in the kernels'
order of chunks, sub-blocks and steps, and holds y, the last state and the
five gradients (with a nonzero gradient of the last state) against the JAX
package's ``selective_scan_mxu`` (its Pallas K7 in interpret mode) and
``jax.grad`` through it: on inputs where some units trip the guard and
others do not (JAX takes its K6 fallback for the whole call there, the same
function), and unguarded on inputs that trip none (JAX's unguarded K7).
Tolerance: the float32 tier, rtol 6e-4 / atol 2e-3, with the absolute part
of dA, dB and dC scaled by max(1, max|JAX|) (sums over steps or channels
in another order).

CPU time: about 10 s (two JAX grad compiles over a 293-step scan).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.ops.scan_pallas_mxu import (
    selective_scan_mxu as j_selective_scan_mxu,
)
from segmamba_tpu_torch.ops import scan_mxu

R, L, D, N = 2, 2 * 128 + 37, 6, 16
T, S = scan_mxu._geometry(L)
TOL = dict(rtol=6e-4, atol=2e-3)
NAMES = ("u", "delta", "A", "B", "C")
FLOOR = -(scan_mxu.MAX_BLOCK_DROP + 10.0)


def _inputs(seed, kind):
    """float32 operands from numpy: "mixed" deltas (softplus of N(-1, 0.5),
    + 2 on the middle chunk) against |A| up to ~40, so that some units trip
    the guard and others do not; "benign" with |A| scaled down so that none
    does. dy and dlast are the cotangents of y and the last state."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    delta = np.log1p(np.exp(f(R, L, D, sc=0.5) - 1.0)).astype(np.float32)
    A = -np.exp(f(D, N, sc=0.5)) * np.arange(1, N + 1, dtype=np.float32)
    if kind == "mixed":
        delta[:, T:2 * T] += np.float32(2.0)
        A = A * np.float32(1.5)
    else:
        A = A * np.float32(0.1)
    return dict(u=f(R, L, D), delta=delta, A=A.astype(np.float32),
                B=f(R, L, N), C=f(R, L, N), dy=f(R, L, D),
                dlast=f(R, D, N))


def _sub_blocks():
    """Per chunk, its sub-blocks as (first, end) steps; the last chunk and
    its last sub-block cut at L."""
    out = []
    for c0 in range(0, L, T):
        out.append([(b, min(b + S, L)) for b in range(c0, min(c0 + T, L), S)])
    return out


def _guard(t, tb, te, guarded):
    """The units' form (R, D, N), True for the ratio form: the serial sum
    of |delta| over the sub-block in step order, times |A|."""
    dabs = torch.zeros(R, D)
    for s in range(tb, te):
        dabs = dabs + t["delta"][:, s].abs()
    if not guarded:
        return torch.ones(R, D, N, dtype=torch.bool)
    return dabs[..., None] * t["A"].abs() < scan_mxu.MAX_BLOCK_DROP


def _step(t, s):
    """Step s's delta (R, D, 1) and b = delta u B (R, D, N)."""
    dl = t["delta"][:, s, :, None]
    return dl, dl * t["u"][:, s, :, None] * t["B"][:, s, None, :]


def _sweep(t, x, blocks, guarded, y=None):
    """A chunk's sub-blocks from the carry x (R, D, N) in K7's arithmetic;
    with y, its outputs C . x. Returns the exit state."""
    A = t["A"]
    for tb, te in blocks:
        m = _guard(t, tb, te, guarded)
        cum, v = torch.zeros(R, D, 1), x
        for s in range(tb, te):
            dl, b = _step(t, s)
            cum = cum + dl
            ell = A * cum
            pinv = torch.exp(-torch.clamp_min(ell, FLOOR))
            v = torch.where(m, v + b * pinv, torch.exp(dl * A) * v + b)
            if y is not None:
                xt = torch.where(m, torch.exp(ell) * v, v)
                y[:, s] = (xt * t["C"][:, s, None, :]).sum(-1)
        x = torch.where(m, v * torch.exp(A * cum), v)
    return x


def _sum_delta(t, blocks):
    sd = torch.zeros(R, D, 1)
    for tb, te in blocks:
        for s in range(tb, te):
            sd = sd + t["delta"][:, s, :, None]
    return sd


def _forward(t, guarded):
    """Sweep 1 per chunk from zero, the fold, sweep 2 from each entry.
    Returns y (R, L, D) and the chunks' exit states (nc, R, D, N)."""
    chunks = _sub_blocks()
    zero = torch.zeros(R, D, N)
    aggs = [_sweep(t, zero, blocks, guarded) for blocks in chunks]
    sds = [_sum_delta(t, blocks) for blocks in chunks]
    entry = [zero]
    for w in range(1, len(chunks)):
        entry.append(torch.exp(t["A"] * sds[w - 1]) * entry[w - 1]
                     + aggs[w - 1])
    y = torch.zeros(R, L, D)
    exits = [_sweep(t, entry[w], blocks, guarded, y)
             for w, blocks in enumerate(chunks)]
    return y, torch.stack(exits)


def _backward(t, exits, guarded):
    """Sweep F per chunk from the saved entry states, the reverse fold from
    dlast, the walk per chunk. Returns the five gradients."""
    A, C, dy = t["A"], t["C"], t["dy"]
    chunks = _sub_blocks()
    nc = len(chunks)
    zero = torch.zeros(R, D, N)
    kept, aggs, sds = [], [], []
    for w, blocks in enumerate(chunks):
        v = exits[w - 1] if w > 0 else zero
        Pc, Pk, h = torch.ones(R, D, N), torch.ones(R, D, N), zero
        steps = []   # per step: (s, form, cum, start, end, kept value)
        for tb, te in blocks:
            m = _guard(t, tb, te, guarded)
            cum = torch.zeros(R, D, 1)
            for s in range(tb, te):
                dl, b = _step(t, s)
                cum = cum + dl
                ell = A * cum
                pinv = torch.exp(-torch.clamp_min(ell, FLOOR))
                a = torch.exp(dl * A)
                v = torch.where(m, v + b * pinv, a * v + b)
                Pc = torch.where(m, Pk * torch.exp(ell), Pc * a)
                h = h + Pc * C[:, s, None, :] * dy[:, s, :, None]
                if s == te - 1:   # the carry P_end v, x at the end
                    v = torch.where(m, v * torch.exp(ell), v)
                    Pk = Pc
                steps.append((s, m, cum, s == tb, s == te - 1, v))
        kept.append(steps)
        aggs.append(h)
        sds.append(_sum_delta(t, blocks))
    gin = [None] * nc
    gin[nc - 1] = t["dlast"]
    for w in range(nc - 2, -1, -1):
        gin[w] = torch.exp(A * sds[w + 1]) * gin[w + 1] + aggs[w + 1]
    du, dd = torch.zeros(R, L, D), torch.zeros(R, L, D)
    dA, dB, dC = torch.zeros(D, N), torch.zeros(R, L, N), torch.zeros(R, L, N)
    for w, steps in enumerate(kept):
        g = gin[w]
        for k in range(len(steps) - 1, -1, -1):
            s, m, cum, start, end, val = steps[k]
            prev = steps[k - 1][5] if k > 0 else (
                exits[w - 1] if w > 0 else zero)
            dl, _ = _step(t, s)
            dx = C[:, s, None, :] * dy[:, s, :, None]
            ell = A * cum
            e1 = torch.where(m, torch.exp(ell), torch.exp(dl * A))
            e2 = torch.exp(-torch.clamp_min(ell, FLOOR))
            grs = e1 * g if end else g
            grs = torch.where(m, grs, g)
            gsum = torch.where(m, e1 * dx, dx) + grs
            gt = torch.where(m, e2 * gsum, gsum)
            dp = gt * (e1 * prev)
            xt = torch.where(m, val if end else e1 * val, val)
            g = torch.where(m, e1 * gt if start else gsum, e1 * gt)
            Ssum = (gt * t["B"][:, s, None, :]).sum(-1)
            du[:, s] = Ssum * t["delta"][:, s]
            dd[:, s] = (dp * A).sum(-1) + Ssum * t["u"][:, s]
            dA += (dp * dl).sum(0)
            dB[:, s] = (gt * dl * t["u"][:, s, :, None]).sum(1)
            dC[:, s] = (xt * dy[:, s, :, None]).sum(1)
    return dict(u=du, delta=dd, A=dA, B=dB, C=dC)


def _jax(a, guarded):
    """JAX's y, last state (batch, dim, N) and the gradients of
    sum(y dy) + sum(last dlast)."""
    def run(*args):
        return j_selective_scan_mxu(*args, return_last_state=True,
                                    guarded=guarded)

    ops = [jnp.asarray(a[n]) for n in NAMES]
    y, last = run(*ops)

    def loss(*args):
        yy, ll = run(*args)
        return (jnp.sum(yy * jnp.asarray(a["dy"]))
                + jnp.sum(ll * jnp.asarray(a["dlast"])))

    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(*ops)
    return np.asarray(y), np.asarray(last), dict(
        zip(NAMES, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("kind,guarded", [("mixed", True),
                                          ("benign", False)])
def test_mxu_chunk_decomposition_matches_jax(kind, guarded):
    a = _inputs(3 if guarded else 4, kind)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    if guarded:   # a mix: some units trip the guard, most do not
        with scan_mxu.tally() as tl:
            scan_mxu.selective_scan_mxu_core_ref(t["u"], t["delta"], t["A"],
                                                 t["B"], t["C"])
        assert 0.05 < tl.share() < 0.98, tl.share()
    y, exits = _forward(t, guarded)
    want_y, want_last, want = _jax(a, guarded)
    np.testing.assert_allclose(y.numpy(), want_y, err_msg="y", **TOL)
    np.testing.assert_allclose(exits[-1].numpy(), want_last,
                               err_msg="last state", **TOL)
    got = _backward(t, exits, guarded)
    for n in NAMES:
        tol = dict(TOL)
        if n in ("A", "B", "C"):
            tol["atol"] = TOL["atol"] * max(1.0, float(np.abs(want[n]).max()))
        assert got[n].shape == want[n].shape, n
        np.testing.assert_allclose(got[n].numpy(), want[n], err_msg=n, **tol)
