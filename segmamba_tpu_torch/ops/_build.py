"""Lazy nvcc build of the port's CUDA sources into ``segmamba_tpu_torch/_build/``.

A source ``csrc/<name>.cu`` with a plain C interface is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library and loaded
with ``ctypes``. The library's file name carries a hash of the source and
the flags (and of the shared headers ``csrc/*.cuh``), so an edited source
builds anew and an unchanged one is reused.
Nothing is built on import: ``load_library`` runs at a kernel's first launch
(or when ``chip_smoke.py`` asks for it).

nvcc is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``; a missing nvcc or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -I csrc: the shared headers, also for copies of a source built elsewhere
# (the probes under tools/ build edited copies in BUILD_DIR)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
              str(CSRC_DIR))

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when reused), "log": nvcc output}
BUILD_INFO: dict[str, dict] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared headers
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _LIBS:
        return _LIBS[name]
    so = library_path(name)
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    _LIBS[name] = lib
    return lib
