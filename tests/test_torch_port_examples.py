"""The port's example recipes (``segmamba_tpu_torch.examples``) against the
JAX package's ``examples/``, on the CPU.

- Each twin's ``get_config().to_json()`` equals its JAX counterpart's.
- ``liver2017_ct``: ``plan`` then ``preprocess`` on one small synthetic CT
  case (anisotropic spacing, HU-like intensities, liver and tumour
  labels) write the same plan and the same preprocessed arrays and
  properties as the JAX recipe's.

CPU time: about 5 s.
"""

import importlib.util
import json
import os
import pathlib
import pickle

import numpy as np
import pytest

from segmamba_tpu_torch.data.nifti import write_nifti
from segmamba_tpu_torch.examples import (
    abdomen_atlas,
    aiib23_airway,
    liver2017_ct,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TWINS = {"abdomen_atlas": abdomen_atlas, "aiib23_airway": aiib23_airway,
         "liver2017_ct": liver2017_ct}


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(TWINS))
def test_config_matches_jax(name):
    assert TWINS[name].get_config().to_json() == \
        _jax_example(name).get_config().to_json()


def _write_ct_case(base, shape=(24, 40, 36), spacing=(2.5, 0.8, 0.8)):
    rng = np.random.default_rng(0)
    case = os.path.join(base, "images", "case_000")
    os.makedirs(case)
    grid = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d = np.sqrt(sum(((g - s / 2) / (s / 3)) ** 2
                    for g, s in zip(grid, shape)))
    seg = np.zeros(shape, np.float32)
    seg[d < 1.0] = 1
    seg[d < 0.4] = 2
    ct = rng.normal(40.0, 15.0, shape).astype(np.float32)
    ct[d >= 1.3] = -1000.0
    ct[seg == 2] += 60.0
    write_nifti(os.path.join(case, "image.nii.gz"), ct, spacing=spacing)
    write_nifti(os.path.join(case, "label.nii.gz"), seg, spacing=spacing)


def test_liver_plan_and_preprocess_match_jax(tmp_path):
    base = str(tmp_path / "raw")
    _write_ct_case(base)
    outs = {}
    plans = {}
    for side, mod in (("jax", _jax_example("liver2017_ct")),
                      ("port", liver2017_ct)):
        cfg = mod.get_config()
        cfg.data.base_dir = base
        cfg.data.preprocessed_dir = str(tmp_path / f"out_{side}")
        mod.plan(cfg)
        with open(os.path.join(base, "plan.json")) as f:
            plans[side] = json.load(f)
        mod.preprocess(cfg, num_processes=1)
        outs[side] = cfg.data.preprocessed_dir
    assert plans["port"] == plans["jax"]
    names = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == names and names
    for n in names:
        a, b = (os.path.join(outs[s], n) for s in ("port", "jax"))
        if n.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        elif n.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                pa, pb = pickle.load(fa), pickle.load(fb)
            assert sorted(pa) == sorted(pb)
            for k in pa:
                if k == "class_locations":
                    for c in pa[k]:
                        np.testing.assert_array_equal(pa[k][c], pb[k][c])
                else:
                    np.testing.assert_equal(pa[k], pb[k], err_msg=k)
