"""The port's case pipeline vs the JAX functions, on the CPU.

One tiny raw case (a brain phantom written as four NIfTI modalities and a
seg, anisotropic spacing, so the resample and its inverse run) goes through
the port's ``SegmentationAlgorithm``, ``python -m segmamba_tpu_torch.
preprocess``, ``predict`` (sliding window and ``--whole-volume``, both with
mirror TTA over the three axes) and ``compute_metrics`` with ``--device
cpu``, and through the JAX package's functions composed in the same order
(``run_case_npy``, ``Predictor`` over the JAX sliding window or
``whole_volume_tta``, the inverse steps, the metrics of
``5_compute_metrics.py``). The model is SegMamba at feats 4/8/16/32, depths
1/1/1/1, hidden 64, random weights (seed 0) on both sides through the
bridge; JAX runs ``scan_impl="chunked"``. The labels must agree wherever
JAX's top-two logit margin exceeds 1e-2 * max|logit|; the metrics must be
equal. Three JAX compiles: the sliding window on the case, the whole-volume
TTA, and the window on the preprocessed ``.npz`` case (same shape as the
first: a cache hit).
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.data import preprocessing as jpre
from segmamba_tpu.data.nifti import read_nifti as j_read_nifti
from segmamba_tpu.infer import Predictor as JPredictor
from segmamba_tpu.infer import SlidingWindowInferer as JInferer
from segmamba_tpu.infer import whole_volume as jwv
from segmamba_tpu.models import SegMamba as JSegMamba
from segmamba_tpu.utils.torch_convert import convert_segmamba_state_dict
from segmamba_tpu_torch import compute_metrics, predict, preprocess
from segmamba_tpu_torch.data.nifti import read_nifti
from segmamba_tpu_torch.data.synthetic import (
    MODALITIES,
    write_raw_phantom_case,
)
from segmamba_tpu_torch.deploy import SegmentationAlgorithm
from segmamba_tpu_torch.models import SegMamba

ROOT = pathlib.Path(__file__).resolve().parent.parent
FEATS, DEPTHS, HIDDEN = (4, 8, 16, 32), (1, 1, 1, 1), 64
ROI = (32, 32, 32)
SLICES = (16, 8, 4, 2)
FRAME = (16, 44, 30)
SPACING = (1.0, 1.0, 1.5)        # (x, y, z): z is resampled 16 -> 24
MIRROR = (0, 1, 2)
MODEL_FLAGS = ["--feats", *map(str, FEATS), "--depths", *map(str, DEPTHS),
               "--hidden-size", str(HIDDEN), "--num-slices",
               *map(str, SLICES), "--roi", *map(str, ROI), "--dtype",
               "float32", "--sw-batch-size", "2", "--device", "cpu"]


def _model():
    return SegMamba(in_chans=4, out_chans=4, depths=DEPTHS, feat_size=FEATS,
                    hidden_size=HIDDEN, num_slices_list=SLICES,
                    generator=torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    raw = root / "raw" / "images"
    _, gt = write_raw_phantom_case(str(raw / "case_0"), FRAME, SPACING,
                                   seed=7)
    model = _model()
    sd = model.state_dict()
    torch.save({"model": sd, "epoch": 0}, root / "trainer.pt")
    (root / "model").mkdir()
    torch.save({"model": sd}, root / "model" / "best_model_0.5000.pt")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               root / "reference.pt")
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_segmamba_state_dict(sd, depths=DEPTHS))
    jm = JSegMamba(in_chans=4, out_chans=4, depths=DEPTHS, feat_size=FEATS,
                   hidden_size=HIDDEN, num_slices_list=SLICES,
                   scan_impl="chunked")
    return dict(root=root, raw=raw, gt=gt, params=params, jm=jm,
                fwd=jax.jit(jm.apply))


def _jax_case(raw_dir):
    vols, spacing = [], None
    for fname in MODALITIES:
        img = j_read_nifti(os.path.join(raw_dir, fname), with_meta=True)
        spacing = img.spacing
        vols.append(img.array.astype(np.float32)[None])
    props = {"spacing": spacing, "name": "case_0"}
    data, _ = jpre.run_case_npy(np.concatenate(vols), None, props,
                                [1.0, 1.0, 1.0], sample_fg=False)
    return data, props


def _jax_labels(logits, props):
    """Labels in the raw frame and the raw-frame mask of voxels whose top
    two logits differ by more than 1e-2 * max|logit|."""
    raw = JPredictor.predict_raw_probability(np.asarray(logits), props)
    top2 = np.sort(raw, axis=0)[-2:]
    sure = (top2[1] - top2[0]) > 1e-2 * np.abs(raw).max()
    seg = np.argmax(raw, axis=0)
    full = JPredictor.predict_noncrop_probability(seg[None], props)[0]
    sure_full = JPredictor.predict_noncrop_probability(sure[None], props,
                                                       fill=True)[0]
    return full, sure_full


def _jax_sliding(env, data, props):
    pred = JPredictor(JInferer(ROI, sw_batch_size=2, overlap=0.5),
                      mirror_axes=MIRROR, predictor_args=(env["params"],))
    logits = pred.maybe_mirror_and_predict(
        jnp.asarray(np.moveaxis(data, 0, -1))[None], env["fwd"])
    return _jax_labels(logits, props)


def _agree(got, want, sure):
    assert got.shape == want.shape == FRAME
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(got[sure], want[sure])


@pytest.fixture(scope="module")
def deployed(env):
    out = env["root"] / "deploy_out"
    algo = SegmentationAlgorithm(
        _model(), str(env["root"] / "trainer.pt"),
        input_dir=str(env["raw"]), output_dir=str(out),
        data_filenames=MODALITIES, roi_size=ROI, sw_batch_size=2,
        overlap=0.5, mirror_axes=MIRROR, device="cpu")
    paths = algo.process()
    return paths, algo


def test_deploy_matches_jax(env, deployed):
    paths, algo = deployed
    assert [os.path.basename(p) for p in paths] == ["case_0.nii.gz"]
    assert set(algo.timings["case_0"]) == {
        "preprocess_s", "predict_s", "inverse_and_write_s"}
    got = read_nifti(paths[0])
    want, sure = _jax_sliding(env, *_jax_case(env["raw"] / "case_0"))
    _agree(got, want, sure)
    assert set(np.unique(got)) <= {0, 1, 2, 3}


@pytest.fixture(scope="module")
def preprocessed(env):
    out = env["root"] / "fullres"
    plan = preprocess.main(["--base-dir", str(env["root"] / "raw"),
                            "--image-dir", "images", "--output-dir",
                            str(out), "--num-processes", "1"])
    assert plan["n_cases"] == 1
    assert sorted(os.listdir(out)) == [
        "case_0.npz", "case_0.pkl", "data_analysis_result.json"]
    return out


def _jax_npz_case(path):
    import pickle
    with np.load(str(path) + ".npz") as z:
        data = z["data"]
    with open(str(path) + ".pkl", "rb") as f:
        return data, pickle.load(f)


@pytest.mark.parametrize("checkpoint", ["reference.pt", "trainer.pt"])
def test_predict_cli_matches_jax_and_deploy(env, deployed, preprocessed,
                                            checkpoint):
    save = env["root"] / f"pred_{checkpoint[:-3]}"
    dices = predict.main(["--data-dir", str(preprocessed), "--checkpoint",
                          str(env["root"] / checkpoint), "--save-dir",
                          str(save), "--split", "0", "0", "1",
                          *MODEL_FLAGS])
    assert len(dices) == 1 and len(dices[0]) == 3
    got = read_nifti(str(save / "case_0.nii.gz"))
    want, sure = _jax_sliding(env, *_jax_npz_case(preprocessed / "case_0"))
    _agree(got, want, sure)
    np.testing.assert_array_equal(got, read_nifti(deployed[0][0]))


def test_predict_whole_volume_matches_jax(env, preprocessed):
    save = env["root"] / "pred_wv"
    predict.main(["--data-dir", str(preprocessed), "--checkpoint",
                  str(env["root"] / "model"), "--save-dir", str(save),
                  "--split", "0", "0", "1", "--whole-volume", *MODEL_FLAGS])
    got = read_nifti(str(save / "case_0.nii.gz"))
    data, props = _jax_npz_case(preprocessed / "case_0")
    logits = jwv.whole_volume_tta(env["jm"], env["params"],
                                  jnp.asarray(np.moveaxis(data, 0, -1))[None],
                                  mirror_axes=MIRROR)
    want, sure = _jax_labels(logits, props)
    _agree(got, want, sure)


def test_checkpoint_dir_without_best_model_raises(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        predict.resolve_checkpoint(str(tmp_path))


def _jax_metrics_script():
    spec = importlib.util.spec_from_file_location(
        "jax_compute_metrics", ROOT / "5_compute_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("raw_gt", [False, True])
def test_compute_metrics_cli_matches_jax(env, deployed, preprocessed,
                                         tmp_path, raw_gt):
    pred_dir = pathlib.Path(deployed[0][0]).parent
    args = ["--pred_name", pred_dir.name, "--pred-dir", str(pred_dir.parent),
            "--out", str(tmp_path)]
    if raw_gt:
        args += ["--gt-dir", str(env["raw"]), "--raw-gt"]
        gt = j_read_nifti(str(env["raw"] / "case_0" / "seg.nii.gz"))
        np.testing.assert_array_equal(gt, env["gt"])
    else:
        args += ["--gt-dir", str(preprocessed)]
        from scipy import ndimage
        with np.load(str(preprocessed / "case_0.npz")) as z:
            seg = z["seg"][0]
        _, props = _jax_npz_case(preprocessed / "case_0")
        tgt = props["shape_after_cropping_before_resample"]
        seg_rs = ndimage.zoom(seg, [t / s for t, s in zip(tgt, seg.shape)],
                              order=0)
        gt = JPredictor.predict_noncrop_probability(seg_rs[None], props)[0]
    arr = compute_metrics.main(args)
    want = _jax_metrics_script().each_case_metric(
        gt, j_read_nifti(deployed[0][0]))
    assert arr.shape == (1, 3, 2) and np.isfinite(arr).all()
    np.testing.assert_array_equal(arr[0], want)
    np.testing.assert_array_equal(
        np.load(tmp_path / f"{pred_dir.name}.npy"), arr)


def test_entry_points_refuse_cuda_without_a_card(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        predict.main(["--checkpoint", str(env["root"] / "trainer.pt")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegmentationAlgorithm(_model(), None, input_dir=".", output_dir=".",
                              data_filenames=MODALITIES)
