"""Port metrics and NIfTI IO vs the JAX package, on the CPU.

Every metric of ``ALL_METRICS``, the confusion matrix and
``convert_labels_brats`` equal JAX's on seeded masks with anisotropic
spacing and on the degenerate cases (empty, full, both empty: the NaN
rules that tests/test_metrics_oracle.py pins). Both are numpy, so equality
is exact (NaN where JAX gives NaN). Files written by either NIfTI writer
read back under the other's reader to the same arrays and headers; the
decoded content is compared, not the gzip bytes.
"""

import gzip

import numpy as np
import pytest

from segmamba_tpu.data import nifti as jnifti
from segmamba_tpu.metrics import metrics as jm
from segmamba_tpu_torch.data import nifti as tnifti
from segmamba_tpu_torch.metrics import metrics as tm

SPACINGS = [None, (1.0, 1.0, 1.0), (0.8, 1.2, 3.0), (2.5, 0.5, 1.0)]


def _masks(seed, shape=(14, 16, 12), p=0.5):
    rng = np.random.default_rng(seed)
    blob = np.zeros(shape, bool)
    c = rng.integers(4, 9, 3)
    r = rng.integers(2, 5, 3)
    blob[c[0] - r[0]:c[0] + r[0], c[1] - r[1]:c[1] + r[1],
         c[2] - r[2]:c[2] + r[2]] = True
    noisy = blob ^ (rng.random(shape) > 1 - 0.1 * p)
    return noisy, blob


def _degenerate():
    z, o = np.zeros((6, 7, 5), bool), np.ones((6, 7, 5), bool)
    m = z.copy()
    m[1:4, 2:5, 1:3] = True
    return [(z, z), (z, m), (m, z), (o, m), (m, o), (o, o), (m, m)]


def _same(a, b):
    return (np.isnan(a) and np.isnan(b)) or a == b


@pytest.mark.parametrize("name", sorted(jm.ALL_METRICS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_matches_jax(name, seed):
    test, ref = _masks(seed)
    spacing = SPACINGS[seed + 1]
    kw = {"voxel_spacing": spacing} if "Distance" in name else {}
    got = tm.ALL_METRICS[name](test, ref, **kw)
    want = jm.ALL_METRICS[name](test, ref, **kw)
    assert _same(got, want), (name, got, want)


@pytest.mark.parametrize("case", range(7))
def test_degenerate_masks_match_jax(case):
    test, ref = _degenerate()[case]
    for name in sorted(jm.ALL_METRICS):
        for nan in (True, False):
            kw = ({"nan_for_nonexisting": nan}
                  if name not in ("Accuracy", "False Positive Rate",
                                  "False Negative Rate") else {})
            got = tm.ALL_METRICS[name](test, ref, **kw)
            want = jm.ALL_METRICS[name](test, ref, **kw)
            assert _same(got, want), (name, nan, got, want)


@pytest.mark.parametrize("spacing", SPACINGS)
def test_surface_distances_match_jax(spacing):
    test, ref = _masks(5)
    np.testing.assert_array_equal(tm._surface_distances(test, ref, spacing),
                                  jm._surface_distances(test, ref, spacing))
    assert (tm.hausdorff_distance_95(test, ref, voxel_spacing=spacing)
            == jm.hausdorff_distance_95(test, ref, voxel_spacing=spacing))


def test_confusion_matrix_matches_jax():
    test, ref = _masks(7)
    assert (tm.ConfusionMatrix(test, ref).get_matrix()
            == jm.ConfusionMatrix(test, ref).get_matrix())
    assert (tm.ConfusionMatrix(test, ref).get_existence()
            == jm.ConfusionMatrix(test, ref).get_existence())
    with pytest.raises(ValueError):
        tm.ConfusionMatrix(test).compute()


@pytest.mark.parametrize("seed", [0, 1])
def test_convert_labels_brats_matches_jax(seed):
    labels = np.random.default_rng(seed).integers(0, 4, (9, 10, 11))
    got = tm.convert_labels_brats(labels)
    assert got.shape == (3, 9, 10, 11) and got.dtype == bool
    np.testing.assert_array_equal(got, jm.convert_labels_brats(labels))


VOLUMES = [
    ("u8.nii.gz", np.uint8, (1.0, 1.0, 1.0)),
    ("i16.nii", np.int16, (0.9, 0.9, 3.0)),
    ("f32.nii.gz", np.float32, (1.2, 0.7, 2.0)),
    ("f64.nii", np.float64, (1.0, 2.0, 0.5)),
    ("bool.nii.gz", np.bool_, (1.0, 1.0, 1.0)),
    ("i64.nii.gz", np.int64, (1.0, 1.0, 1.0)),     # stored as float32
]


def _volume(dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((7, 9, 5)) * 50
    return (a > 0) if dtype is np.bool_ else a.astype(dtype)


@pytest.mark.parametrize("fname,dtype,spacing", VOLUMES)
@pytest.mark.parametrize("writer,reader", [(tnifti, jnifti),
                                           (jnifti, tnifti)])
def test_nifti_round_trip_across_packages(tmp_path, fname, dtype, spacing,
                                          writer, reader):
    arr = _volume(dtype, len(fname))
    affine = np.diag([*spacing, 1.0])
    affine[:3, 3] = (-10.0, 4.5, 7.25)
    path = str(tmp_path / fname)
    writer.write_nifti(path, arr, spacing=spacing, affine=affine)
    img = reader.read_nifti(path, with_meta=True)
    twin = (jnifti if reader is tnifti else tnifti).read_nifti(
        path, with_meta=True)
    np.testing.assert_array_equal(img.array, twin.array)
    np.testing.assert_array_equal(img.array, arr.astype(img.array.dtype))
    assert img.array.shape == (7, 9, 5)
    assert img.spacing == twin.spacing == pytest.approx(spacing)
    np.testing.assert_array_equal(img.affine, twin.affine)
    np.testing.assert_allclose(img.affine, affine, rtol=1e-6)


def test_nifti_headers_and_content_equal(tmp_path):
    """The two writers' files decode to the same bytes."""
    arr = _volume(np.int16, 3)
    paths = [str(tmp_path / f"{n}.nii.gz") for n in ("port", "jax")]
    tnifti.write_nifti(paths[0], arr, spacing=(1.0, 0.5, 2.0))
    jnifti.write_nifti(paths[1], arr, spacing=(1.0, 0.5, 2.0))
    raw = [gzip.open(p).read() for p in paths]
    assert raw[0] == raw[1]


def test_nifti_scl_slope_applied_alike(tmp_path):
    arr = _volume(np.int16, 4)
    path = str(tmp_path / "scaled.nii")
    tnifti.write_nifti(path, arr, spacing=(1.0, 1.0, 1.0))
    with open(path, "r+b") as f:               # slope 0.5, intercept -3
        f.seek(112)
        f.write(np.asarray([0.5, -3.0], "<f4").tobytes())
    got, want = tnifti.read_nifti(path), jnifti.read_nifti(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, arr * 0.5 - 3.0)


def test_nifti_rejects_what_jax_rejects(tmp_path):
    path = str(tmp_path / "bad.nii")
    with open(path, "wb") as f:
        f.write(b"\x00" * 400)
    for mod in (tnifti, jnifti):
        with pytest.raises(ValueError, match="not a NIfTI-1 file"):
            mod.read_nifti(path)
        with pytest.raises(ValueError, match="3-D"):
            mod.write_nifti(path, np.zeros((2, 2)))
