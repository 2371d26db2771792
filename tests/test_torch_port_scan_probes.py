"""The scan probes K10 and K11: the port's benchmark twins
(``segmamba_tpu_torch.benchmarks.bench_scan_lb`` / ``bench_scan_flat``)
against the JAX scripts ``benchmarks/bench_scan_lb.py`` /
``benchmarks/bench_scan_flat.py``, on the CPU.

The same numpy inputs (seeded) go to both. The JAX side runs its Pallas
kernels (``_kernel``, ``_fwd_kernel_flat``) in interpret mode: each test
swaps the imported script's module attribute ``pl`` for a shim whose
``pallas_call`` adds ``interpret=True``; no file of the JAX side changes.
Importing the scripts sets three JAX cache options and puts
``benchmarks/`` on ``sys.path``; the fixture puts all four back. The port
side runs its plain versions (CPU tensors). The CUDA kernels are held
against these plain versions on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phase 17).

Tolerances: float32 rtol 6e-4 / atol 2e-3, one bfloat16 case compared in
float32 at rtol 3e-2 / atol 5e-2 (the port's tiers). Shapes: R = 2, L =
512 and 384 (4 and 3 chunks of 128), D = 8, N = 16.

CPU time: about 15 s (the interpret-mode JAX kernels, one trace per
shape).
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from segmamba_tpu_torch.benchmarks import (
    bench_scan_flat,
    bench_scan_lb,
    microbench,
)
from segmamba_tpu_torch.ops.scan_fused import mamba_scan_fused_ref

ROOT = pathlib.Path(__file__).resolve().parent.parent
F32 = dict(rtol=6e-4, atol=2e-3)
BF16 = dict(rtol=3e-2, atol=5e-2)
CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_entry_size_bytes",
                 "jax_persistent_cache_min_compile_time_secs")


class _InterpretPallas:
    """``pallas`` as the scripts use it, with every ``pallas_call`` run in
    interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def jax_scripts():
    """The two JAX scripts as modules; the JAX options and ``sys.path``
    they change on import are put back."""
    saved = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    path = list(sys.path)
    mods = {}
    try:
        for name in ("bench_scan_lb", "bench_scan_flat"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_{name}", ROOT / "benchmarks" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mods


@pytest.fixture
def interpret(jax_scripts, monkeypatch):
    for mod in jax_scripts.values():
        monkeypatch.setattr(mod, "pl", _InterpretPallas())
    return jax_scripts


def _inputs(seed, R=2, L=512, D=8, N=16):
    """(u, dt, z, A, B, C, D, dt_bias) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    u, dt, z = f(R, L, D), f(R, L, D, sc=0.5), f(R, L, D)
    A = -np.exp(f(D, N))
    return u, dt, z, A, f(R, L, N), f(R, L, N), f(D), f(D, sc=0.3)


def _both(arrays, dtype):
    """The inputs for JAX and for the port: the sequences in ``dtype``,
    the parameters float32."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    seq = (0, 1, 2, 4, 5)
    j = [jnp.asarray(a, jdt if i in seq else jnp.float32)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(dtype if i in seq else torch.float32)
         for i, a in enumerate(arrays)]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


CASES = [("noshift", 512, torch.float32), ("nohs", 512, torch.float32),
         ("noshift", 384, torch.float32), ("nohs", 384, torch.float32),
         ("noshift", 512, torch.bfloat16)]


@pytest.mark.parametrize("variant,L,dtype", CASES)
def test_variant_call_ref_matches_jax(interpret, variant, L, dtype):
    """K10's plain version (serial carry, JAX's order of float operations)
    against JAX's ``variant_call`` in interpret mode."""
    j, t = _both(_inputs(L + len(variant), L=L), dtype)
    want = interpret["bench_scan_lb"].variant_call(*j, variant)
    got = bench_scan_lb.variant_call_ref(*t, variant)
    assert got.dtype == dtype and got.shape == (2, L, 8)
    _close(got, want, F32 if dtype == torch.float32 else BF16)


@pytest.mark.parametrize("L,dtype", [(512, torch.float32),
                                     (384, torch.float32),
                                     (512, torch.bfloat16)])
def test_flat_call_ref_matches_jax_and_fused_scan(interpret, L, dtype):
    """K11's plain version against JAX's ``flat_call`` in interpret mode and
    against the port's plain K2 (``mamba_scan_fused_ref``): the same
    function."""
    j, t = _both(_inputs(L + 1, L=L), dtype)
    want = interpret["bench_scan_flat"].flat_call(*j)
    got = bench_scan_flat.flat_call_ref(*t)
    tol = F32 if dtype == torch.float32 else BF16
    _close(got, want, tol)
    _close(got, mamba_scan_fused_ref(*t).float().numpy(), tol)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the entry points are the plain versions, bit for
    bit, and no kernel launch is counted."""
    _, t = _both(_inputs(5), torch.float32)
    before = (bench_scan_lb.LAUNCHES, bench_scan_flat.LAUNCHES)
    for v in bench_scan_lb.VARIANTS:
        assert torch.equal(bench_scan_lb.variant_call(*t, v),
                           bench_scan_lb.variant_call_ref(*t, v))
    assert torch.equal(bench_scan_flat.flat_call(*t),
                       bench_scan_flat.flat_call_ref(*t))
    assert (bench_scan_lb.LAUNCHES, bench_scan_flat.LAUNCHES) == before


@pytest.mark.parametrize("entry", ["lb", "flat"])
def test_unsupported_calls_raise(entry):
    """L not a multiple of 128 raises (JAX leaves that tail unwritten), a
    meta tensor raises (no kernel, no fallback), an unknown variant
    raises."""
    _, t = _both(_inputs(6, L=384), torch.float32)
    call = (bench_scan_flat.flat_call if entry == "flat" else
            lambda *a: bench_scan_lb.variant_call(*a, "nohs"))
    with pytest.raises(ValueError, match="multiple of T"):
        call(*(x[:, :300] if x.dim() == 3 else x for x in t))
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(*(x.to("meta") for x in t))
    if entry == "lb":
        with pytest.raises(ValueError, match="unknown variant"):
            bench_scan_lb.variant_call(*t, "shift")


def test_mains_print_their_lines(capsys):
    """Both twins' mains on the CPU at tiny shapes print the JAX scripts'
    lines; on the card's default device they raise where there is none."""
    small = ["--device", "cpu", "--L", "256", "--dim", "8", "--k", "1"]
    bench_scan_lb.main(small)
    bench_scan_flat.main(small)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("production kernel: ")
    assert lines[2].startswith("variant noshift : ")
    assert lines[3].startswith("variant nohs    : ")
    assert lines[5].startswith("batch=1: ref ") and " flat " in lines[5]
    assert lines[6].startswith("batch=3: ref ") and " err " in lines[6]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_scan_lb.main(["--L", "256", "--dim", "8"])


def test_chain_time_and_device_names():
    calls = []
    t = microbench.chain_time(lambda x: calls.append(x), (torch.ones(2),),
                              k=3, reps=2)
    assert t >= 0.0 and len(calls) == 1 + 3 * 2
    assert microbench.device_name(torch.device("cpu")) == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        microbench.resolve_device("meta")
