"""Scans at d_state other than 16 through the kernels' state-group logic,
on the CPU.

The CUDA templates of K1-K5 and K8 are built for N = 16 states; the
wrappers run any N as ceil(N / 16) launches (``scan_dir._group_fwd`` /
``_group_bwd``, and ``scan_proj._group_bwd`` for K8's backward). Here those
host functions run with the plain N = 16 scan in the kernel's place, at
d_state 4 (one group, zero-padded states) and 32 (two groups chained
through ``acc``), against the plain scan at the full N and against the
JAX package's ``mamba_scan_fused_dir`` / ``mamba_scan_fused`` (Pallas in
interpret mode). The dir2 chain's flag sets, the fused gate, the slice
order (K5's mode) and K8's chain links; forward output and chunk exit
states, and every gradient. Float32; tolerance rtol 2e-4 / atol 2e-5, the
JAX package's tier for these scans (tests/test_scan_dir.py:114): the
groups only split the sum over states.

CPU time: about 12 s (6 interpret-mode JAX forwards).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segmamba_tpu.ops.scan_pallas_dir import mamba_scan_fused_dir as j_dir
from segmamba_tpu.ops.scan_pallas_fused import mamba_scan_fused as j_fused
from segmamba_tpu_torch.ops import scan_dir, scan_proj

R, L, D, RANK, S = 2, 200, 40, 3, 4
TOL = dict(rtol=2e-4, atol=2e-5)
FLAGS = {
    "dir_reverse": dict(reverse=True, gate=False, acc=False, nslices=0),
    "dir_gate_acc": dict(reverse=False, gate=True, acc=True, nslices=0),
    "fused": dict(reverse=False, gate=True, acc=False, nslices=0),
    "slice": dict(reverse=False, gate=True, acc=False, nslices=S),
}
GRADS = ("du", "ddt", "dz", "dacc", "dA", "dB", "dC", "dD", "dbias")


def _inputs(seed, N):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32))
    return dict(u=f(R, L, D), dt=f(R, L, D, sc=0.2), z=f(R, L, D),
                acc=f(R, L, D), A=-torch.exp(f(D, N)), B=f(R, L, N),
                C=f(R, L, N), D=f(D), bias=f(D, sc=0.3), dout=f(R, L, D))


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               err_msg=name, **TOL)


@pytest.mark.parametrize("N", [4, 32])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_dir_state_groups_match_full_n_and_jax(N, flag):
    """``scan_dir._group_fwd`` / ``_group_bwd`` with the plain 16-state
    scan per group == the plain scan at the full N (output, chunk exit
    states, all nine gradients) == JAX's kernel (output)."""
    fl = FLAGS[flag]
    a = _inputs(N + len(flag), N)
    z = a["z"] if fl["gate"] else None
    acc = a["acc"] if fl["acc"] else None
    seq = (a["u"], a["dt"])
    kw = dict(reverse=fl["reverse"], chunk_size=128, nslices=fl["nslices"])
    calls = []

    def launch(acc_g, A_g, B_g, C_g, D_g, gate_g):
        assert A_g.shape[-1] == B_g.shape[-1] == C_g.shape[-1] == 16
        calls.append(gate_g)
        return scan_dir._plain(*seq, z if gate_g else None, acc_g, A_g, B_g,
                               C_g, D_g, a["bias"], gate=gate_g,
                               return_states=True, **kw)

    out, states, last_acc = scan_dir._group_fwd(
        acc, a["A"], a["B"], a["C"], a["D"], gate=fl["gate"], launch=launch)
    groups = -(-N // 16)
    assert calls == [False] * (groups - 1) + [fl["gate"]]
    want, want_states = scan_dir._plain(
        *seq, z, acc, a["A"], a["B"], a["C"], a["D"], a["bias"],
        gate=fl["gate"], return_states=True, **kw)
    _close(out, want, "out")
    _close(states, want_states, "states")

    def launch_bwd(acc_g, A_g, B_g, C_g, D_g, gate_g, dout_g, states_g):
        assert states_g.shape[2] == 16
        return scan_dir._plain_bwd(*seq, z if gate_g else None, acc_g, A_g,
                                   B_g, C_g, D_g, a["bias"], dout_g,
                                   gate=gate_g, **kw)

    got = scan_dir._group_bwd(acc, a["A"], a["B"], a["C"], a["D"], a["dout"],
                              states, last_acc, gate=fl["gate"],
                              launch_bwd=launch_bwd)
    want_g = scan_dir._plain_bwd(*seq, z, acc, a["A"], a["B"], a["C"],
                                 a["D"], a["bias"], a["dout"],
                                 gate=fl["gate"], **kw)
    for name, g, w in zip(GRADS, got, want_g):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.shape == w.shape, name
            _close(g, w, f"{name} N={N} {flag}")

    if flag == "slice":   # JAX's slice kernel asks for (S, Tp) blocks
        return
    j = lambda t: None if t is None else jnp.asarray(t.numpy())
    args = [j(a[k]) for k in ("u", "dt")] + [j(z)] + [
        j(a[k]) for k in ("A", "B", "C", "D", "bias")]
    if flag == "fused":
        ref = j_fused(*args)
    else:   # JAX's dir entry takes per-row parameters
        rows = lambda t: jnp.broadcast_to(t, (R, *t.shape))
        args[3], args[6], args[7] = (rows(args[i]) for i in (3, 6, 7))
        ref = j_dir(*args, acc=j(acc), gate=fl["gate"],
                    reverse=fl["reverse"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("N", [4, 32])
@pytest.mark.parametrize("link", ["reverse_acc", "forward_acc_gate"])
def test_proj_state_groups_match_full_n(N, link):
    """K8's groups (``scan_dir._group_fwd`` over x_proj's B and C columns,
    ``scan_proj._group_bwd``) with the plain 16-state K8 per group == the
    plain K8 at the full N: output, chunk exit states and the eight
    gradients (x_proj's dt, B and C columns among them)."""
    rng = np.random.default_rng(N)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32))
    xc, W = f(R, L, D), f(D, RANK + 2 * N, sc=0.3)
    dtp, bias, A = f(RANK, D, sc=0.5), f(D, sc=0.3), -torch.exp(f(D, N))
    Dsk, acc, dout = f(D), f(R, L, D), f(R, L, D)
    z = f(R, L, D) if link == "forward_acc_gate" else None
    reverse = link == "reverse_acc"

    Wdt, WB, WC = scan_proj._split_proj(W, N)

    def launch(acc_g, A_g, WB_g, WC_g, D_g, gate_g):
        assert WB_g.shape[1] == WC_g.shape[1] == 16
        return scan_proj.mamba_scan_proj_ref(
            xc, torch.cat([Wdt, WB_g, WC_g], 1), dtp, bias, A_g, D_g,
            z=z if gate_g else None, acc=acc_g, reverse=reverse,
            return_states=True)

    out, states, last_acc = scan_dir._group_fwd(
        acc, A, WB, WC, Dsk, gate=z is not None, launch=launch)
    want, want_states = scan_proj.mamba_scan_proj_ref(
        xc, W, dtp, bias, A, Dsk, z=z, acc=acc, reverse=reverse,
        return_states=True)
    _close(out, want, "out")
    _close(states, want_states, "states")

    def launch_bwd(W_g, A_g, D_g, z_g, acc_g, dout_g, states_g):
        return scan_proj.mamba_scan_proj_bwd_ref(
            xc, W_g, dtp, bias, A_g, D_g, dout_g, z=z_g, acc=acc_g,
            reverse=reverse)

    got = scan_proj._group_bwd(W, A, Dsk, z, acc, dout, states, last_acc,
                               launch_bwd=launch_bwd)
    want_g = scan_proj.mamba_scan_proj_bwd_ref(xc, W, dtp, bias, A, Dsk,
                                               dout, z=z, acc=acc,
                                               reverse=reverse)
    names = ("dxc", "dx_proj", "ddt_proj", "ddt_bias", "dA", "dD", "dz",
             "dacc")
    for name, g, w in zip(names, got, want_g):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.shape == w.shape, name
            _close(g, w, f"{name} N={N} {link}")


@pytest.mark.parametrize("N", [4, 32])
def test_entry_points_take_any_d_state_on_cpu(N):
    """The public entry points at N != 16 (CPU: the plain versions), with
    gradients through their autograd Functions: no launch is counted."""
    a = _inputs(7, N)
    leaves = {k: a[k].clone().requires_grad_() for k in ("u", "A", "B")}
    before = (scan_dir.LAUNCHES, scan_dir.BWD_LAUNCHES,
              scan_proj.LAUNCHES)
    out = scan_dir.mamba_scan_fused_dir(
        leaves["u"], a["dt"], a["z"], leaves["A"], leaves["B"], a["C"],
        a["D"], a["bias"])
    out.square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves.values())
    assert leaves["A"].grad.shape == (D, N)
    assert (scan_dir.LAUNCHES, scan_dir.BWD_LAUNCHES,
            scan_proj.LAUNCHES) == before
