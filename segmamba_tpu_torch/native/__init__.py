"""Native (C++/OpenMP) host kernels of the data path.

A copy of ``segmamba_tpu/native``: ``affine_transform_3d`` (nearest,
trilinear, or Catmull-Rom cubic at order 3) and ``crop_pad``, the
resampler of the host augmentation chain's spatial transform and the patch
sampler's crop. Two differences from the JAX package:

- the extension is built at the first call (``build.build``), not at
  import, and a failed build raises with the compiler's output instead of
  falling back;
- scipy / numpy run only on request: ``SEGMAMBA_DISABLE_NATIVE=1`` (the
  variable the JAX package reads), read at every call.

With the variable set, order 0 and 1 give the same values as the
extension; order 3 is scipy's B-spline, which the extension's Catmull-Rom
replaces (both C1 cubic interpolants).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from segmamba_tpu_torch.native import build as _build_mod

_MODULE = None   # the loaded extension, once built


def native_disabled() -> bool:
    """True when ``SEGMAMBA_DISABLE_NATIVE=1`` asks for scipy / numpy."""
    return os.environ.get("SEGMAMBA_DISABLE_NATIVE") == "1"


def module():
    """The extension module, built and loaded on first use."""
    global _MODULE
    if _MODULE is None:
        path = _build_mod.build()
        spec = importlib.util.spec_from_file_location(
            f"segmamba_tpu_torch.native.{_build_mod.MODULE}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULE = mod
    return _MODULE


def affine_transform_3d(volume, matrix, offset, order=1, cval=0.0):
    """out[o] = in[matrix @ o + offset]; scipy.affine_transform convention."""
    if native_disabled():
        from scipy import ndimage
        return ndimage.affine_transform(
            np.asarray(volume, np.float32), matrix, offset=offset,
            order=order, mode="constant", cval=cval).astype(np.float32)
    return module().affine_transform_3d(
        np.ascontiguousarray(volume, np.float32),
        np.ascontiguousarray(matrix, np.float64),
        np.ascontiguousarray(offset, np.float64), int(order), float(cval))


def crop_pad(data, lb, patch, cval=0.0):
    """Extract ``patch`` starting at (possibly negative) ``lb`` from
    (C, Z, Y, X), padding out-of-range with ``cval``."""
    if native_disabled():
        data = np.asarray(data, np.float32)
        shape = data.shape[1:]
        ub = [lb[i] + patch[i] for i in range(3)]
        vlb = [max(0, lb[i]) for i in range(3)]
        vub = [min(shape[i], ub[i]) for i in range(3)]
        sl = (slice(None),) + tuple(slice(a, b) for a, b in zip(vlb, vub))
        padding = [(vlb[i] - lb[i], ub[i] - vub[i]) for i in range(3)]
        return np.pad(data[sl], ((0, 0), *padding), constant_values=cval)
    return module().crop_pad(
        np.ascontiguousarray(data, np.float32),
        tuple(int(v) for v in lb), tuple(int(v) for v in patch),
        float(cval))
