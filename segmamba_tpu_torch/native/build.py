"""Build the native host resampler (``augment_native.cpp``) with g++.

The source's code is the JAX package's, a CPython extension module
(``_augment_native``: ``affine_transform_3d`` and ``crop_pad``, OpenMP),
built with the same flags into ``segmamba_tpu_torch/_build/``. The file
name carries a hash of the source, the flags, the include directories and
the CPU that ``-march=native`` resolves to, so an edited source or another
machine builds anew and an unchanged one is reused. g++ writes to a
temporary name that is then renamed into place: the loader's worker
processes may build at the same moment and never see half a file.

Nothing is built on import; ``native.affine_transform_3d`` / ``crop_pad``
call ``build`` at their first use. A failed build raises with g++'s
output. ``python -m segmamba_tpu_torch.native.build`` builds and prints
the path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "augment_native.cpp"
BUILD_DIR = HERE.parent / "_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
         "-std=c++17")
MODULE = "_augment_native"


def _includes():
    return (f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}")


def _native_arch():
    """What ``-march=native`` means on this machine, as g++ reports it."""
    proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    return "\n".join(line for line in proc.stdout.splitlines()
                     if line.strip().startswith(("-march=", "-mtune=")))


def so_path() -> Path:
    key = hashlib.sha256(
        SRC.read_bytes()
        + " ".join(FLAGS + _includes()).encode()
        + _native_arch().encode()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"{MODULE}_{key}{suffix}"


def build(verbose=False) -> Path:
    """Compile the extension unless this source and machine already have
    it; returns its path. Raises ``RuntimeError`` with g++'s output when the
    compile fails."""
    out = so_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", prefix=out.name + ".",
                               dir=BUILD_DIR)
    os.close(fd)
    tmp = Path(tmp)
    cmd = ["g++", *FLAGS, *_includes(), str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build(verbose=True))
