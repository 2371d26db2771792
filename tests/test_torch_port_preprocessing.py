"""Port preprocessing and planning vs the JAX package, on the CPU.

``run_case_npy``, ``resample_to_shape`` (separate-z on and off, images and
labels), ``build_plan`` and a two-case ``MultiModalityPreprocessor.run``
(the port's with two spawned workers, JAX's in this process) into
``tmp_path`` must give JAX's arrays and properties exactly: both are the
same numpy and scipy calls. The raw cases are brain phantoms written by
``segmamba_tpu_torch.data.synthetic.write_raw_phantom_case``.
"""

import os
import pickle

import numpy as np
import pytest

from segmamba_tpu.data import planning as jplan
from segmamba_tpu.data import preprocessing as jpre
from segmamba_tpu_torch.data import planning as tplan
from segmamba_tpu_torch.data import preprocessing as tpre
from segmamba_tpu_torch.data.synthetic import (
    phantom_case,
    write_raw_phantom_case,
)

SHAPE = (12, 30, 26)


def _assert_props_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "class_locations":
            assert sorted(got[k]) == sorted(want[k])
            for c in want[k]:
                np.testing.assert_array_equal(got[k][c], want[k][c])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("spacing,crop,resample", [
    ((1.0, 1.0, 1.0), True, True),
    ((0.9, 0.9, 3.5), True, True),        # separate z
    ((1.2, 0.8, 1.0), False, True),
    ((1.0, 1.0, 2.0), True, False),
])
def test_run_case_npy_matches_jax(spacing, crop, resample):
    images, labels = phantom_case(SHAPE, seed=3)
    out = []
    for mod in (tpre, jpre):
        props = {"spacing": spacing, "raw_size": SHAPE, "name": "c"}
        data, seg = mod.run_case_npy(
            images.astype(np.float32), labels[None].astype(np.float32),
            props, [1.0, 1.0, 1.0], do_crop=crop, do_resample=resample)
        out.append((data, seg, props))
    (d, s, p), (jd, js, jp) = out
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(s, js)
    assert s.dtype == js.dtype
    _assert_props_equal(p, jp)


def test_run_case_npy_without_seg_matches_jax():
    images, _ = phantom_case(SHAPE, seed=4)
    res = []
    for mod in (tpre, jpre):
        props = {"spacing": (0.7, 0.7, 2.5), "name": "c"}
        data, seg = mod.run_case_npy(images, None, props, [1.0, 1.0, 1.0],
                                     sample_fg=False)
        res.append((data, seg, props))
    for got, want in zip(res[0][:2], res[1][:2]):
        np.testing.assert_array_equal(got, want)
    _assert_props_equal(res[0][2], res[1][2])


@pytest.mark.parametrize("is_seg,sep", [(False, True), (False, False),
                                        (True, True), (True, None)])
def test_resample_to_shape_matches_jax(is_seg, sep):
    images, labels = phantom_case(SHAPE, seed=5)
    data = labels[None] if is_seg else images[:2].astype(np.float32)
    kw = dict(current_spacing=(3.5, 0.9, 0.9), is_seg=is_seg,
              order=1 if is_seg else 3, order_z=0, force_separate_z=sep)
    new_shape = (30, 25, 22)
    got = tpre.resample_to_shape(data, new_shape, **kw)
    want = jpre.resample_to_shape(data, new_shape, **kw)
    assert got.shape == (data.shape[0], *new_shape) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_build_plan_matches_jax():
    rng = np.random.default_rng(6)
    spacings = [[3.0, 0.9, 0.9], [2.5, 1.0, 1.0], [3.2, 0.8, 0.85]]
    shapes = [[40, 200, 180], [52, 190, 170], [36, 210, 205]]
    fg = [[rng.normal(100 + 10 * c, 20, 500) for c in range(2)]
          for _ in spacings]
    got = tplan.build_plan(spacings, shapes, fg)
    assert got == jplan.build_plan(spacings, shapes, fg)
    assert (tplan.ct_norm_params_from_plan(got, 1)
            == jplan.ct_norm_params_from_plan(got, 1))


def test_preprocessor_run_matches_jax(tmp_path):
    raw = tmp_path / "raw" / "images"
    for i, spacing in enumerate([(1.0, 1.0, 1.0), (0.8, 0.8, 3.0)]):
        write_raw_phantom_case(str(raw / f"case_{i}"), SHAPE, spacing,
                               seed=10 + i)
    plans, outs = [], []
    for mod, workers in ((tpre, 2), (jpre, 1)):
        pp = mod.MultiModalityPreprocessor(
            base_dir=str(tmp_path / "raw"), image_dir="images",
            data_filenames=["t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz",
                            "t1c.nii.gz"], seg_filename="seg.nii.gz")
        plans.append(pp.run_plan())
        out = tmp_path / mod.__name__.split(".")[0]
        pp.run(output_spacing=[1.0, 1.0, 1.0], output_dir=str(out),
               all_labels=[1, 2, 3], num_processes=workers)
        outs.append(out)
    assert plans[0] == plans[1]
    names = sorted(os.listdir(outs[1]))
    assert sorted(os.listdir(outs[0])) == names == [
        "case_0.npz", "case_0.pkl", "case_1.npz", "case_1.pkl"]
    for name in names:
        got, want = (str(o / name) for o in outs)
        if name.endswith(".npz"):
            with np.load(got) as g, np.load(want) as w:
                assert sorted(g.files) == sorted(w.files) == ["data", "seg"]
                for k in w.files:
                    np.testing.assert_array_equal(g[k], w[k])
                    assert g[k].dtype == w[k].dtype
        else:
            with open(got, "rb") as f, open(want, "rb") as h:
                _assert_props_equal(pickle.load(f), pickle.load(h))
