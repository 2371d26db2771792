"""The port's data copies and Trainer, on the CPU.

- The copied data modules (``segmamba_tpu_torch.data``) give arrays
  identical to ``segmamba_tpu.data``'s for one seed: the patch sampler, the
  augmentation chains and the loader (channels-last in JAX, NCDHW in the
  port). The JAX package's optional C++ resampler is switched off for the
  comparison, so both sides resample with scipy.
- ``python -m segmamba_tpu_torch.train`` (its ``main``) at the tiny config
  on a synthetic preprocessed dataset written to ``tmp_path``: 2 epochs x 2
  steps, validation every epoch; the loss is finite, ``best_model_*`` and
  ``final_model_*`` appear, and ``--resume`` continues at the saved epoch
  and step, as the JAX trainer does.
- A dataset pickles (to a loader process) as its case list.
- The flags whose machinery is not ported raise and name it.

CPU time: about 15 s.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from segmamba_tpu import native as jax_native
from segmamba_tpu.data import augment as j_augment
from segmamba_tpu.data.dataset import MedicalDataset as JMedicalDataset
from segmamba_tpu.data.loader import DataLoader as JDataLoader
from segmamba_tpu.data.patch_sampler import PatchSampler as JPatchSampler
from segmamba_tpu_torch.data import augment as t_augment
from segmamba_tpu_torch.data import (
    DataLoader,
    MedicalDataset,
    PatchSampler,
)
from segmamba_tpu_torch.data.synthetic import write_synthetic_cases
from segmamba_tpu_torch.train.__main__ import main as train_main
from segmamba_tpu_torch.train.trainer import Trainer

TINY = ["--feats", "4", "8", "16", "32", "--depths", "1", "1", "1", "1",
        "--hidden-size", "64", "--num-slices", "8", "4", "2", "1"]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    folder = tmp_path_factory.mktemp("cases")
    write_synthetic_cases(str(folder), 4, (36, 40, 34), seed=0)
    return str(folder)


@pytest.fixture
def scipy_only(monkeypatch):
    """The JAX package resamples with scipy, as the port does."""
    monkeypatch.setattr(jax_native, "_native", None)


def _paths(folder):
    return sorted(glob.glob(os.path.join(folder, "*.npz")))


def test_sampler_matches_jax(cases, scipy_only):
    jd, td = JMedicalDataset(_paths(cases)), MedicalDataset(_paths(cases))
    js = JPatchSampler(jd, (32, 48, 24), batch_size=3,
                       rng=np.random.default_rng(5))
    ts = PatchSampler(td, (32, 48, 24), batch_size=3,
                      rng=np.random.default_rng(5))
    for _ in range(3):
        a, b = js.generate_train_batch(), ts.generate_train_batch()
        np.testing.assert_array_equal(a["keys"], b["keys"])
        np.testing.assert_array_equal(a["data"], b["data"])
        np.testing.assert_array_equal(a["seg"], b["seg"])


@pytest.mark.parametrize("chain", ["default", "spatial_always", "onlymirror",
                                   "validation"])
def test_augmentation_matches_jax(cases, scipy_only, chain):
    td = MedicalDataset(_paths(cases))
    batch = PatchSampler(td, (24, 24, 24), batch_size=2,
                         rng=np.random.default_rng(1)).generate_train_batch()
    make = {
        "default": lambda m: m.get_train_transforms(),
        "spatial_always": lambda m: m._chain(
            lambda b, r: m.spatial_transform(b, r, p_rot=1.0, p_scale=1.0)),
        "onlymirror": lambda m: m.get_train_transforms_onlymirror(),
        "validation": lambda m: m.get_validation_transforms(),
    }[chain]
    for seed in range(3):
        a = make(j_augment)({k: np.copy(v) for k, v in batch.items()},
                            np.random.default_rng(seed))
        b = make(t_augment)({k: np.copy(v) for k, v in batch.items()},
                            np.random.default_rng(seed))
        np.testing.assert_array_equal(a["data"], b["data"])
        np.testing.assert_array_equal(a["seg"], b["seg"])


def test_loader_matches_jax_in_ncdhw(cases, scipy_only):
    kw = dict(num_workers=0, steps_per_epoch=2, seed=3)
    jl = JDataLoader(JPatchSampler(JMedicalDataset(_paths(cases)),
                                   (24, 24, 24),
                                   rng=np.random.default_rng(2)),
                     transform=j_augment.get_train_transforms(), **kw)
    tl = DataLoader(PatchSampler(MedicalDataset(_paths(cases)), (24, 24, 24),
                                 rng=np.random.default_rng(2)),
                    transform=t_augment.get_train_transforms(), **kw)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.moveaxis(a["image"], -1, 1),
                                      b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert b["label"].dtype == np.int64


def test_dataset_pickles_as_its_case_list(cases):
    """A loader process gets the dataset through a pipe: it must not carry
    the properties (megabytes of class_locations), and must rebuild them."""
    import pickle

    ds = MedicalDataset(_paths(cases))
    blob = pickle.dumps(ds)
    assert len(blob) < 4096
    back = pickle.loads(blob)
    assert back.datalist == ds.datalist
    for a, b in zip(back.properties, ds.properties):
        for k in a["class_locations"]:
            np.testing.assert_array_equal(a["class_locations"][k],
                                          b["class_locations"][k])
    np.testing.assert_array_equal(back[1]["data"], ds[1]["data"])


def _run(cases, logdir, *extra):
    return train_main(["--data-dir", cases, "--logdir", logdir,
                       "--batch-size", "2", "--val-every", "1",
                       "--steps-per-epoch", "2", "--val-number", "2",
                       "--patch", "32", "32", "32", "--num-workers", "0",
                       "--dtype", "float32", "--split", "0.5", "0.5", "0.0",
                       "--device", "cpu", *TINY, *extra])


def test_train_cli_trains_saves_and_resumes(cases, tmp_path, capsys):
    logdir = str(tmp_path / "logs")
    trainer = _run(cases, logdir, "--max-epochs", "2")
    assert np.isfinite(trainer.last_loss)
    assert trainer.global_step == 4 and trainer.epoch == 1
    names = sorted(os.listdir(os.path.join(logdir, "model")))
    assert [n.rsplit("_", 1)[0] for n in names] == [
        "best_model", "final_model"], names
    saved = torch.load(glob.glob(os.path.join(logdir, "model",
                                              "final_model_*.pt"))[0],
                       weights_only=True)
    assert (saved["epoch"], saved["step"]) == (1, 4)

    # as the JAX trainer: the saved epoch 1 runs again, then epoch 2
    trainer = _run(cases, logdir, "--max-epochs", "3", "--resume")
    assert "at epoch 1, step 4" in capsys.readouterr().out
    assert trainer.global_step == 8 and trainer.epoch == 2
    assert np.isfinite(trainer.last_loss)
    assert len(os.listdir(os.path.join(logdir, "model"))) == 2


@pytest.mark.parametrize("flag", [["--data-parallel"],
                                  ["--seq-parallel", "2"]])
def test_unported_flags_raise(flag):
    with pytest.raises(SystemExit, match="ROADMAP A"):
        train_main(flag)


@pytest.mark.parametrize("plan_patch,patch", [
    ([128, 128, 128], [128, 128, 128]),
    ([160, 192, 112], [160, 192, 96]),
    ([20, 70, 300], [32, 64, 288]),
])
def test_plan_sets_patch_and_slices(tmp_path, capsys, plan_patch, patch):
    """``--plan`` takes the plan's patch rounded down to multiples of 32 (at
    least 32) and the slice counts from its depth, as 3_train.py does."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"patch_size": plan_patch}))
    train_main(["--plan", str(path), "--print-config"])
    cfg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cfg["patch"] == patch
    assert cfg["num_slices"] == [max(1, patch[0] // 2 ** (i + 1))
                                 for i in range(4)]


def test_device_augmentation_raises():
    with pytest.raises(NotImplementedError, match="later slice"):
        Trainer(torch.nn.Linear(1, 1), "unused", augmentation="device",
                device="cpu")
