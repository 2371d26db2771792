"""Deployment wrapper: raw volumes in, segmentations out.

Port of ``segmamba_tpu/deploy.py`` (the reference's grand-challenge
algorithm shell, light_training/process_framework/process.py:8-30): for
each case directory of an input directory, read the raw NIfTI modalities,
preprocess them in-process (``run_case_npy``: crop, z-score, resample),
predict with the sliding window and mirror TTA on the model's device, undo
the resample and the crop, and write the labels as NIfTI, with no
intermediate ``.npz``. ``timings`` holds each case's seconds by step.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from segmamba_tpu_torch.data.nifti import read_nifti
from segmamba_tpu_torch.data.preprocessing import run_case_npy
from segmamba_tpu_torch.infer import Predictor, SlidingWindowInferer
from segmamba_tpu_torch.train.checkpoint import load_model_weights


class SegmentationAlgorithm:
    """``model`` is moved to ``device`` (default the card; no card raises)
    and loaded from ``checkpoint_path`` unless that is None (the weights
    the model holds). The model's own ``dtype`` sets the compute dtype."""

    def __init__(self, model, checkpoint_path, *, input_dir, output_dir,
                 data_filenames, out_spacing=(1.0, 1.0, 1.0),
                 roi_size=(128, 128, 128), sw_batch_size=2, overlap=0.5,
                 mirror_axes=(0, 1, 2), normalize_fn=None,
                 postprocess_largest_cc=False, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device available")
        self.model = model.to(self.device).eval()
        if checkpoint_path is not None:
            load_model_weights(self.model, checkpoint_path)
        self.input_dir = input_dir
        self.output_dir = output_dir
        self.data_filenames = list(data_filenames)
        self.out_spacing = list(out_spacing)
        self.normalize_fn = normalize_fn
        self.postprocess_largest_cc = postprocess_largest_cc
        inferer = SlidingWindowInferer(tuple(roi_size),
                                       sw_batch_size=sw_batch_size,
                                       overlap=overlap)
        self.predictor = Predictor(inferer, mirror_axes=mirror_axes)
        self.timings = {}

    def list_cases(self):
        return sorted(
            d for d in os.listdir(self.input_dir)
            if os.path.isdir(os.path.join(self.input_dir, d)))

    def process_case(self, case_name):
        """Run one case; returns the written NIfTI's path."""
        t0 = time.perf_counter()
        case_dir = os.path.join(self.input_dir, case_name)
        vols, spacing = [], (1.0, 1.0, 1.0)
        for fname in self.data_filenames:
            img = read_nifti(os.path.join(case_dir, fname), with_meta=True)
            spacing = img.spacing
            vols.append(img.array.astype(np.float32)[None])
        data = np.concatenate(vols, axis=0)
        properties = {"spacing": spacing, "raw_size": data.shape[1:],
                      "name": case_name}
        kwargs = {"sample_fg": False}
        if self.normalize_fn is not None:
            kwargs["normalize_fn"] = self.normalize_fn
        data, _ = run_case_npy(data, None, properties, self.out_spacing,
                               **kwargs)
        t1 = time.perf_counter()

        x = torch.from_numpy(data)[None].to(self.device)
        logits = self.predictor.maybe_mirror_and_predict(x, self.model).cpu()
        t2 = time.perf_counter()

        raw = Predictor.predict_raw_probability(logits, properties)
        seg = np.argmax(raw, axis=0)
        full = Predictor.predict_noncrop_probability(seg[None], properties)
        path = Predictor.save_to_nii(
            full, properties, self.output_dir, name=case_name,
            spacing=spacing,
            postprocess_largest_cc=self.postprocess_largest_cc)
        self.timings[case_name] = {
            "preprocess_s": t1 - t0, "predict_s": t2 - t1,
            "inverse_and_write_s": time.perf_counter() - t2}
        return path

    def process(self):
        paths = []
        for case in self.list_cases():
            print(f"processing {case} ...")
            paths.append(self.process_case(case))
        return paths
