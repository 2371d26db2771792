"""The port's data copies and Trainer, on the CPU.

- The copied data modules (``segmamba_tpu_torch.data``) give arrays
  identical to ``segmamba_tpu.data``'s for one seed: the patch sampler, the
  augmentation chains and the loader (channels-last in JAX, NCDHW in the
  port). The chains run with each side's default resampler (the C++
  extensions, Catmull-Rom at order 3) and, through ``scipy_only``, with
  both sides on scipy (the JAX extension switched off, the port's through
  ``SEGMAMBA_DISABLE_NATIVE=1``); the sampler and loader tests use
  ``scipy_only``.
- ``python -m segmamba_tpu_torch.train`` (its ``main``) at the tiny config
  on a synthetic preprocessed dataset written to ``tmp_path``: 2 epochs x 2
  steps, validation every epoch, with the host chain and with
  ``--augmentation device`` (raw patches, the chain inside the step); the
  loss is finite, ``best_model_*`` and ``final_model_*`` appear, and
  ``--resume`` continues at the saved epoch and step, as the JAX trainer
  does.
- ``Trainer(augmentation="device")`` leaves the loader's patches raw and
  draws each step's parameters from (seed + 7, step).
- The loader's worker processes pass batches through shared memory and
  they arrive as the workers made them.
- A dataset pickles (to a loader process) as its case list.
- ``--data-parallel`` / ``--seq-parallel N`` build 3_train.py's mesh from
  the launched world size (``--print-config`` shows it) and refuse a world
  they cannot cover; ``--data-parallel --seq-parallel 2`` trains an epoch
  on 4 spawned CPU ranks (gloo, ``parallel.multihost.launch``; the ranks
  run ``parallel.workers.train_cli``). Sequence ranks with loader worker
  processes train and validate on the same batches, and a resume that only
  the main process can see reaches every rank.

CPU time: about 40 s.
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
from segmamba_tpu_torch.parallel import workers
from segmamba_tpu_torch.parallel.multihost import launch
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
    """Both packages resample and crop with scipy / numpy: the JAX
    extension switched off, the port's by its variable."""
    monkeypatch.setattr(jax_native, "_native", None)
    monkeypatch.setenv("SEGMAMBA_DISABLE_NATIVE", "1")


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


@pytest.mark.parametrize("resampler", ["native", "scipy"])
@pytest.mark.parametrize("chain", ["default", "spatial_always", "onlymirror",
                                   "validation"])
def test_augmentation_matches_jax(cases, request, chain, resampler):
    if resampler == "scipy":
        request.getfixturevalue("scipy_only")
    else:
        assert jax_native.NATIVE_AVAILABLE, "the JAX package's default"
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


def test_loader_processes_pass_batches_in_shared_memory(cases):
    """With worker processes each batch crosses the queue as shared-memory
    tensors and comes out as the arrays the worker made: numpy, the port's
    layout and dtypes, equal to one of the workers' own first batches."""
    sampler = PatchSampler(MedicalDataset(_paths(cases)), (24, 24, 24))
    loader = DataLoader(sampler, num_workers=2, steps_per_epoch=3, seed=7)
    try:
        got = list(loader)
    finally:
        loader.stop()
    want = []
    for i in range(2):
        sampler.rng = np.random.default_rng(7 + i)
        want += [DataLoader._to_device_layout(sampler.generate_train_batch())
                 for _ in range(3)]
    for b in got:
        assert isinstance(b["image"], np.ndarray)
        assert b["image"].dtype == np.float32 and b["label"].dtype == np.int64
        assert any(all(np.array_equal(b[k], w[k]) for k in w) for w in want)


def test_loader_stops_with_batches_of_exited_workers(cases):
    """``stop`` drains the queue while workers remain; a queued batch whose
    worker has already exited (its shared memory gone) is dropped, not
    raised."""
    import time

    loader = DataLoader(PatchSampler(MedicalDataset(_paths(cases)),
                                     (16, 16, 16)),
                        num_workers=2, num_cached=4, seed=1)
    loader.start()
    deadline = time.monotonic() + 60
    while loader._queue.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.1)
    first = loader._workers[0]
    first.terminate()
    first.join(timeout=10)
    loader.stop()
    assert loader._workers == [] and loader._queue is None


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


def test_trainer_device_augmentation(cases, tmp_path, monkeypatch):
    """``augmentation="device"``: no host transform, so the loader's labels
    keep the crop's -1; the step's parameters come from (seed + 7,
    step)."""
    from segmamba_tpu_torch.data import augment_device
    from segmamba_tpu_torch.models import SegMamba
    from segmamba_tpu_torch.train import trainer as trainer_mod

    assert trainer_mod._pick_transform("device") is None
    drawn = []
    real = augment_device.augment_generator

    def spy(seed, step):
        drawn.append((seed, step))
        return real(seed, step)

    monkeypatch.setattr(trainer_mod, "augment_generator", spy)
    model = SegMamba(in_chans=4, out_chans=4, depths=(1, 1, 1, 1),
                     feat_size=(4, 8, 16, 32), hidden_size=64,
                     num_slices_list=(8, 4, 2, 1),
                     generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, str(tmp_path / "logs"), max_epochs=1,
                 num_step_per_epoch=2, patch_size=(32, 32, 32),
                 augmentation="device", num_workers=0, seed=3, device="cpu")
    tr.train(MedicalDataset(_paths(cases)))
    assert drawn == [(10, 0), (10, 1)]
    assert tr.global_step == 2 and np.isfinite(tr.last_loss)


def _run(cases, logdir, *extra):
    return train_main(["--data-dir", cases, "--logdir", logdir,
                       "--batch-size", "2", "--val-every", "1",
                       "--steps-per-epoch", "2", "--val-number", "2",
                       "--patch", "32", "32", "32", "--num-workers", "0",
                       "--dtype", "float32", "--split", "0.5", "0.5", "0.0",
                       "--device", "cpu", *TINY, *extra])


@pytest.mark.parametrize("augmentation", ["default", "device"])
def test_train_cli_trains_saves_and_resumes(cases, tmp_path, capsys,
                                            augmentation):
    logdir = str(tmp_path / "logs")
    aug = ["--augmentation", augmentation]
    trainer = _run(cases, logdir, "--max-epochs", "2", *aug)
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
    trainer = _run(cases, logdir, "--max-epochs", "3", "--resume", *aug)
    assert "at epoch 1, step 4" in capsys.readouterr().out
    assert trainer.global_step == 8 and trainer.epoch == 2
    assert np.isfinite(trainer.last_loss)
    assert len(os.listdir(os.path.join(logdir, "model"))) == 2


@pytest.mark.parametrize("flags,world,mesh", [
    (["--data-parallel"], 4, {"data": 4}),
    (["--data-parallel", "--seq-parallel", "2"], 4, {"data": 2, "seq": 2}),
    (["--seq-parallel", "4"], 4, {"data": 1, "seq": 4}),
    ([], 1, None),
])
def test_parallel_flags_print_the_mesh(monkeypatch, capsys, flags, world,
                                       mesh):
    """The mesh of 3_train.py:148-159 from the launched world size
    (``WORLD_SIZE``, as torchrun sets it)."""
    monkeypatch.setenv("WORLD_SIZE", str(world))
    train_main([*flags, "--print-config"])
    cfg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cfg["mesh"] == mesh


@pytest.mark.parametrize("flags,world,match", [
    (["--seq-parallel", "3"], 2, "--seq-parallel 3 does not divide 2"),
    (["--data-parallel", "--seq-parallel", "3"], 4, "does not divide 4"),
    (["--seq-parallel", "2"], 4, "needs --data-parallel"),
    ([], 2, "pass --data-parallel or --seq-parallel"),
])
def test_parallel_flags_reject_the_world(monkeypatch, flags, world, match):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit, match=match):
        train_main([*flags, "--print-config"])


def test_data_seq_parallel_epoch_on_four_ranks(cases, tmp_path):
    """``--data-parallel --seq-parallel 2`` on 4 spawned CPU ranks (gloo):
    one epoch of 2 steps (a sample a data rank) and a validation on 3
    patches split over the 2 data ranks; every rank ends at the same
    step and loss, and the main process alone writes the checkpoints."""
    logdir = str(tmp_path / "logs")
    argv = ["--data-dir", cases, "--logdir", logdir, "--batch-size", "2",
            "--val-every", "1", "--steps-per-epoch", "2", "--val-number",
            "3", "--patch", "32", "32", "32", "--num-workers", "0",
            "--dtype", "float32", "--split", "0.5", "0.5", "0.0",
            "--device", "cpu", "--max-epochs", "1", "--augmentation",
            "noaug", "--data-parallel", "--seq-parallel", "2", *TINY]
    ranks = launch(workers.train_cli, 4, argv, device="cpu", timeout_s=600)
    assert [r["global_step"] for r in ranks] == [2] * 4
    assert [r["batch_rows"] for r in ranks] == [1] * 4
    assert np.isfinite(ranks[0]["last_loss"])
    # a data rank's two sequence ranks train on the same rows
    assert ranks[0]["last_loss"] == ranks[1]["last_loss"]
    assert ranks[2]["last_loss"] == ranks[3]["last_loss"]
    assert [n.rsplit("_", 1)[0] for n in ranks[0]["files"]] == [
        "best_model", "final_model"]
    assert sorted(os.listdir(os.path.join(logdir, "model"))) == ranks[0][
        "files"]


def test_sequence_ranks_train_on_the_same_batches(cases, tmp_path):
    """Two sequence ranks of one data coordinate, with loader worker
    processes (which deliver in their own order): both train and validate
    on the same batches, so their losses agree step by step. A resume
    where only the main process can see the checkpoint (each rank has its
    own log directory) takes every rank to the same step and parameters."""
    case = dict(shape=(1, 2), data_dir=cases, logdir=str(tmp_path),
                model_kw=dict(in_chans=4, out_chans=4, depths=(1, 1, 1, 1),
                              feat_size=(4, 8, 16, 32), hidden_size=64,
                              num_slices_list=(8, 4, 2, 1)),
                batch_size=1, steps=3, val_number=2, patch=(32, 32, 32),
                num_workers=2)
    r0, r1 = launch(workers.trainer_replicas, 2, case, device="cpu",
                    timeout_s=600)
    for a, b in zip(r0, r1):
        assert a["seen"] == b["seen"]
        assert a["losses"] == b["losses"]
        assert a["global_step"] == b["global_step"]
        for k, v in a["params"].items():
            np.testing.assert_array_equal(v, b["params"][k])
    first, resumed = r0
    assert first["global_step"] == 3 and len(first["seen"]) == 3 + 2
    assert len(set(first["seen"])) > 1
    assert np.isfinite(first["losses"]).all()
    # the resume starts from the saved step: epoch 0 again, then epoch 1
    assert resumed["global_step"] == 3 + 2 * 3
    assert [n.rsplit("_", 1)[0] for n in first["files"]] == [
        "best_model", "final_model"]
    assert r1[0]["files"] == r1[1]["files"] == []


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

