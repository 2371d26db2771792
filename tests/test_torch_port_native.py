"""The port's native host resampler (``segmamba_tpu_torch.native``)
against the JAX package's, on the CPU.

- ``affine_transform_3d`` equals the JAX package's native output at orders
  0, 1 and 3 (the same C++ source, built by each package), with fill 0 and
  -1; ``crop_pad`` equals it exactly, padding on every side.
- ``SEGMAMBA_DISABLE_NATIVE=1``, read at each call, gives scipy's /
  numpy's values (what the JAX package gives without its extension).
- A source that does not compile raises with the compiler's output (no
  fallback); builds started at once from several threads all load the one
  library, written under a temporary name and renamed into place.

CPU time: a few seconds (one g++ build of a broken source).
"""

import threading

import numpy as np
import pytest
from scipy import ndimage

from segmamba_tpu import native as jax_native
from segmamba_tpu_torch import native
from segmamba_tpu_torch.native import build


@pytest.fixture(scope="module", autouse=True)
def _jax_native_built():
    assert jax_native.NATIVE_AVAILABLE, "g++ builds the JAX extension here"


@pytest.mark.parametrize("cval", [0.0, -1.0])
@pytest.mark.parametrize("order", [0, 1, 3])
def test_affine_transform_matches_jax_native(order, cval):
    rng = np.random.default_rng(order)
    vol = rng.standard_normal((13, 17, 21)).astype(np.float32)
    a = 0.4
    c, s = np.cos(a), np.sin(a)
    mat = np.array([[1, 0, 0], [0, c, -s], [0, s, c]]) * 1.13
    center = (np.asarray(vol.shape) - 1) / 2.0
    off = center - mat @ center + np.array([0.3, -1.2, 0.7])
    got = native.affine_transform_3d(vol, mat, off, order=order, cval=cval)
    want = jax_native.affine_transform_3d(vol, mat, off, order=order,
                                          cval=cval)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_crop_pad_matches_jax_native():
    d = np.random.default_rng(2).standard_normal((3, 20, 22, 24)).astype(
        np.float32)
    for lb in [(-3, 5, 20), (0, 0, 0), (15, 18, 20), (-8, -8, -8)]:
        np.testing.assert_array_equal(
            native.crop_pad(d, lb, (16, 16, 16), -1.0),
            jax_native.crop_pad(d, lb, (16, 16, 16), -1.0))


def test_disable_variable_gives_scipy(monkeypatch):
    vol = np.random.default_rng(4).standard_normal((10, 12, 14)).astype(
        np.float32)
    mat, off = np.eye(3) * 1.07, np.full(3, -0.7)
    monkeypatch.setenv("SEGMAMBA_DISABLE_NATIVE", "1")
    got = native.affine_transform_3d(vol, mat, off, order=3)
    want = ndimage.affine_transform(vol, mat, offset=off, order=3,
                                    mode="constant", cval=0.0)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    d = vol[None]
    np.testing.assert_array_equal(native.crop_pad(d, (-2, 3, 5), (8, 8, 8)),
                                  jax_native.crop_pad(d, (-2, 3, 5),
                                                      (8, 8, 8)))
    monkeypatch.delenv("SEGMAMBA_DISABLE_NATIVE")
    assert not np.array_equal(
        native.affine_transform_3d(vol, mat, off, order=3), got)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "augment_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build()
    assert not list((tmp_path / "_build").iterdir())   # no partial file


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    paths, errors = [], []

    def go():
        try:
            paths.append(build.build())
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [
        paths[0].name]
