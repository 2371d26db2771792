"""K9's benchmark twin (``segmamba_tpu_torch.benchmarks.bench_conv``)
against the JAX script ``benchmarks/bench_conv.py``, on the CPU.

The same seeded numpy inputs go to both. The twin's yardstick
``torch_conv`` (``F.conv3d`` on channels_last_3d views) is held against the
script's ``xla_conv``, and the port's ``conv3d_k3s1`` (its plain versions on
CPU tensors) against the script's ``conv3d_k3s1``, whose Pallas kernels run
in interpret mode off the TPU (``conv3d_pallas._interpret``), forward and
the gradients of sum(conv) that the script's grad rows time. Importing the
script (with ``benchmarks/`` on ``sys.path``, as when it runs as a
script) sets three JAX cache options and puts the repository root on
``sys.path``; the fixture puts them back and drops the script's
``microbench`` module again.

Float32 at rtol 1e-5 / atol 2e-5 (both sides sum float32 products in
different orders, as ``tests/test_torch_port_conv3d.py``); the twin's
``main`` runs once at a tiny spatial size and prints the script's two lines
per shape.

CPU time: a few seconds (one interpret-mode forward and VJP at 4 x 6 x 5).
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu_torch.benchmarks import bench_conv

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=2e-5)
CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_entry_size_bytes",
                 "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_script():
    """``benchmarks/bench_conv.py`` as a module; the JAX options and
    ``sys.path`` it changes on import are put back."""
    saved = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    path = list(sys.path)
    had_microbench = "microbench" in sys.modules
    try:
        # run as a script, its own directory (and microbench) is on the path
        sys.path.insert(0, str(ROOT / "benchmarks"))
        spec = importlib.util.spec_from_file_location(
            "_jax_bench_conv", ROOT / "benchmarks" / "bench_conv.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
        if not had_microbench:
            sys.modules.pop("microbench", None)
    return mod


def _inputs(seed, B=1, D=4, H=6, W=5, cin=8, cout=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, cin)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 3, cin, cout))).astype(np.float32)
    return x, w


def test_yardstick_matches_xla_conv(jax_script):
    """``torch_conv`` (the card's cuDNN call) computes the script's
    ``xla_conv``: SAME, NDHWC x DHWIO."""
    x, w = _inputs(1)
    want = jax_script.xla_conv(jnp.asarray(x), jnp.asarray(w))
    got = bench_conv.torch_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_and_its_grad_rows_match_jax(jax_script):
    """The port's ``conv3d_k3s1`` against the script's (Pallas, interpret
    mode): the forward and the gradients in (x, w) of sum(conv), the grad
    row's function, through ``value_and_grad``."""
    x, w = _inputs(2)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        bench_conv.conv3d_k3s1(tx, tw).numpy(),
        np.asarray(jax_script.conv3d_k3s1(jx, jw)), **TOL)
    loss = lambda a, b: jnp.sum(jax_script.conv3d_k3s1(a, b).astype(
        jnp.float32))
    want = jax.grad(loss, argnums=(0, 1))(jx, jw)
    got = bench_conv.value_and_grad(bench_conv.conv3d_k3s1)(tx, tw)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)
    yard = bench_conv.value_and_grad(bench_conv.torch_conv)(tx, tw)
    for g, w_ in zip(yard, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


def test_shapes_and_main_on_the_cpu(jax_script, capsys):
    """The twin keeps the script's six shapes; its main on the CPU at a
    tiny spatial size prints a forward and a grad line per shape; on the
    card's default device it raises where there is none."""
    assert bench_conv.SHAPES == jax_script.SHAPES
    bench_conv.main(["--device", "cpu", "--spatial", "4", "--k", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu" and len(lines) == 1 + 2 * 6
    for i, (_, cin, cout) in enumerate(bench_conv.SHAPES):
        fwd, grad = lines[1 + 2 * i], lines[2 + 2 * i]
        assert fwd.startswith(f"4^3 {cin}->{cout}: cudnn ") and \
            " | kernel " in fwd
        assert grad.lstrip().startswith("grad: cudnn ") and " kernel " in grad
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_conv.main(["--spatial", "4"])
