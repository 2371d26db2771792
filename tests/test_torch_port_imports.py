"""The port imports no JAX: the machine with the card has none of it.

Walks ``segmamba_tpu_torch/**/*.py``, ``chip_smoke.py`` and the card
tools ``tools/scan_fwd_timeline.py``, ``tools/scan_bwd_probe.py``,
``tools/scan_bwd_ab.py``, ``tools/mxu_ab.py`` and ``tools/proj_ab.py``
with ``ast``
(a ``sys.modules`` check would be wrong wherever something imports jax at
interpreter start-up) and fails on any import of jax, flax, optax or the
JAX package. Also checks that importing the port builds nothing: no
kernel library and not the native host resampler.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "segmamba_tpu")
SOURCES = sorted((ROOT / "segmamba_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [ROOT / "tools" / f for f in (
        "scan_fwd_timeline.py", "scan_bwd_probe.py", "scan_bwd_ab.py",
        "mxu_ab.py", "proj_ab.py")]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_builds_nothing():
    """Importing every module of the port loads no kernel library and
    does not build the native resampler."""
    code = (
        "import pkgutil, importlib, segmamba_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'segmamba_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from segmamba_tpu_torch.ops import _build\n"
        "from segmamba_tpu_torch import native\n"
        "assert not _build._LIBS and not _build.BUILD_INFO\n"
        "assert native._MODULE is None\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
