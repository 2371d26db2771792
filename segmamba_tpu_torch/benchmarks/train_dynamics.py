"""Training-dynamics drive of the port: the BraTS recipe on the card.

Twin of ``benchmarks/train_dynamics.py``. It writes synthetic structured
cases (``make_cases``: four modalities whose intensity shifts inside a
nested ellipsoid tumour, through the port's NIfTI writer and
preprocessor), then trains the reference configuration: batch 2 x 4 x
128^3 patches, the full-width SegMamba in bfloat16 compute with float32
parameters and ``remat="convs"``, SGD nesterov 0.99 with poly LR and clip
12, CE, validation on 4 patches (TC/WT/ET dice). ``--augmentation``
defaults to ``device``: the augmentation chain runs on the card inside the
train step.

The run goes in two processes, as a preempted job would: the first trains
until a checkpoint has been written and a few steps more, and is then
killed (SIGKILL, with its loader processes); the second resumes from the
checkpoint and trains to the end. Every step's loss, step seconds, data
wait and peak memory, and every validation's dice, are recorded; the
summary checks that the resumed run starts at the checkpoint's epoch and
step and that every loss is finite.

It is a drive, not the port's benchmark: it prints a JSON summary (and
writes it to ``--out``) and nothing else.

    python -m segmamba_tpu_torch.benchmarks.train_dynamics --steps 300 \\
        --out train_dynamics.json
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

MODALITIES = ["t1.nii.gz", "t1ce.nii.gz", "t2.nii.gz", "flair.nii.gz"]
PATCH = (128, 128, 128)
RESUME_TIMEOUT = 3000.0    # seconds the resumed run may take


def make_cases(base, n_cases=5, shape=(150, 180, 150), seed=0,
               num_processes=4):
    """Synthetic raw cases under ``base/raw``, preprocessed into
    ``base/fullres`` (returned)."""
    from segmamba_tpu_torch.data import MultiModalityPreprocessor, write_nifti

    raw = os.path.join(base, "raw")
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        case = os.path.join(raw, "images", f"case_{i:03d}")
        os.makedirs(case, exist_ok=True)
        Z, Y, X = shape
        zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                                 indexing="ij")
        cz, cy, cx = rng.integers(40, Z - 40), rng.integers(50, Y - 50), \
            rng.integers(40, X - 40)
        r1, r2, r3 = rng.integers(12, 25, 3)
        d2 = ((zz - cz) / r1) ** 2 + ((yy - cy) / r2) ** 2 \
            + ((xx - cx) / r3) ** 2
        seg = np.zeros(shape, np.float32)
        seg[d2 < 1.0] = 2
        seg[d2 < 0.45] = 1
        seg[d2 < 0.15] = 3
        for m, name in enumerate(MODALITIES):
            vol = rng.standard_normal(shape).astype(np.float32) * 5 + 80
            # tumour classes shift intensity per modality: a learnable signal
            vol += (seg == 1) * (20 + 10 * m) + (seg == 2) * (-15 - 5 * m) \
                + (seg == 3) * (35 - 8 * m)
            write_nifti(os.path.join(case, name), vol,
                        spacing=(1.0, 1.0, 1.0))
        write_nifti(os.path.join(case, "seg.nii.gz"), seg,
                    spacing=(1.0, 1.0, 1.0))
    pp = MultiModalityPreprocessor(
        base_dir=raw, image_dir="images", data_filenames=MODALITIES,
        seg_filename="seg.nii.gz")
    out = os.path.join(base, "fullres")
    pp.run(output_spacing=[1.0, 1.0, 1.0], output_dir=out,
           all_labels=[1, 2, 3], num_processes=num_processes)
    return out


def plan(steps, steps_per_epoch):
    """Epochs, validation period, and the step after which the first run
    is killed: a few steps (10 at most) past the end of the first
    validated epoch at or after half the run (its checkpoint then
    exists)."""
    epochs = -(-steps // steps_per_epoch)
    val_every = max(2, epochs // 3)
    val_epochs = [e for e in range(epochs) if (e + 1) % val_every == 0]
    ckpt_epoch = next((e for e in val_epochs if (e + 1) * 2 >= epochs),
                      val_epochs[0])
    if ckpt_epoch >= epochs - 1:
        raise ValueError(f"--steps {steps} at {steps_per_epoch} a epoch "
                         "leaves no epoch after the checkpoint to kill in")
    ckpt_step = (ckpt_epoch + 1) * steps_per_epoch
    margin = max(1, min(10, steps_per_epoch // 2))
    return epochs, val_every, ckpt_epoch, ckpt_step, ckpt_step + margin


# -- the training process ----------------------------------------------------


def _write(f, rec):
    f.write(json.dumps(rec) + "\n")
    f.flush()


def train_child(args):
    """One training process: ``BraTSTrainer`` with every step and
    validation recorded to ``args.record`` (JSON lines)."""
    import torch

    from segmamba_tpu_torch.data import get_train_val_test_loader_from_train
    from segmamba_tpu_torch.models import SegMamba
    from segmamba_tpu_torch.train.__main__ import BraTSTrainer

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    record = open(args.record, "a")

    class DynamicsTrainer(BraTSTrainer):
        def on_step(self, metrics):
            super().on_step(metrics)
            _write(record, {
                "phase": args.phase, "step": self.global_step,
                "epoch": self.epoch, "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "step_s": self.timer.last("step_time"),
                "data_wait_s": self.timer.last("data_wait"),
                "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if cuda else None)})

        def validation_end(self, state, val_outputs):
            mean_dice = super().validation_end(state, val_outputs)
            _write(record, {
                "phase": args.phase, "validation": True,
                "step": self.global_step, "epoch": self.epoch,
                "mean_dice": mean_dice,
                "dice": np.asarray(val_outputs).mean(axis=0).tolist()})
            return mean_dice

    epochs, val_every, _, _, _ = plan(args.steps, args.steps_per_epoch)
    model = SegMamba(in_chans=4, out_chans=4, dtype=torch.bfloat16,
                     remat="convs",
                     generator=torch.Generator().manual_seed(42))
    trainer = DynamicsTrainer(
        model, os.path.join(args.dir, "logs"), max_epochs=epochs,
        batch_size=2, val_every=val_every,
        num_step_per_epoch=args.steps_per_epoch, val_number=4,
        patch_size=PATCH, augmentation=args.augmentation,
        learning_rate=1e-2, scheduler_type="poly", loss="ce",
        num_classes=4, num_workers=args.num_workers, seed=42,
        resume=args.phase == "resumed", device=device)
    train_ds, val_ds, _ = get_train_val_test_loader_from_train(
        os.path.join(args.dir, "fullres"), train_rate=0.6, val_rate=0.2,
        test_rate=0.2)
    trainer.train(train_ds, val_ds)
    record.close()


# -- the supervisor ----------------------------------------------------------


def _records(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def _child_cmd(args, phase):
    cmd = [sys.executable, "-m", "segmamba_tpu_torch.benchmarks.train_dynamics",
           "--child", "--phase", phase]
    for k in ("dir", "steps", "steps_per_epoch", "augmentation",
              "num_workers", "device", "record"):
        cmd += [f"--{k.replace('_', '-')}", str(getattr(args, k))]
    return cmd


def _kill_group(proc):
    """SIGKILL the process and everything in its session (its loader
    processes)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def run_phases(args):
    """The first run until ``kill_step``, killed; the resumed run to the
    end. Returns the records."""
    _, _, _, _, kill_step = plan(args.steps, args.steps_per_epoch)
    first = subprocess.Popen(_child_cmd(args, "first"),
                             start_new_session=True)
    try:
        while first.poll() is None:
            recs = [r for r in _records(args.record) if "loss" in r]
            if recs and recs[-1]["step"] >= kill_step:
                break
            time.sleep(0.2)
        else:
            raise RuntimeError(f"the first run exited ({first.returncode}) "
                               f"before step {kill_step}")
    finally:
        _kill_group(first)
    resumed = subprocess.Popen(_child_cmd(args, "resumed"),
                               start_new_session=True)
    try:
        rc = resumed.wait(timeout=RESUME_TIMEOUT)
    finally:
        _kill_group(resumed)
    if rc != 0:
        raise RuntimeError(f"the resumed run exited with {rc}")
    return _records(args.record)


def summarize(records, args):
    """The trajectory (first run to its checkpoint, then the resumed run),
    its times and the resume checks."""
    _, _, ckpt_epoch, ckpt_step, kill_step = plan(args.steps,
                                                  args.steps_per_epoch)
    steps = {p: [r for r in records if r["phase"] == p and "loss" in r]
             for p in ("first", "resumed")}
    vals = [r for r in records if r.get("validation")]
    traj = ([r for r in steps["first"] if r["step"] <= ckpt_step]
            + steps["resumed"])
    losses = [r["loss"] for r in traj]
    resumed0 = steps["resumed"][0]
    # the steps after each process's first 3 (start-up, first batches)
    steady = [r for p in steps.values() for r in p[3:]]
    step_s = [r["step_s"] for r in steady]
    waits = [r["data_wait_s"] for r in steady]
    checks = {
        "first_run_killed_at": steps["first"][-1]["step"],
        "resumed_first_step": resumed0["step"],
        "resumed_first_epoch": resumed0["epoch"],
        "resume_ok": (resumed0["step"] == ckpt_step + 1
                      and resumed0["epoch"] == ckpt_epoch),
        "losses_finite": bool(np.all(np.isfinite(losses))),
    }
    peaks = [r["peak_gib"] for r in steady if r["peak_gib"] is not None]
    return {
        "augmentation": args.augmentation,
        "steps_run": len(steps["first"]) + len(steps["resumed"]),
        "trajectory_steps": len(traj),
        "checkpoint": {"epoch": ckpt_epoch, "step": ckpt_step,
                       "kill_after_step": kill_step},
        "loss_first20_mean": float(np.mean(losses[:20])),
        "loss_last20_mean": float(np.mean(losses[-20:])),
        "loss_every_10": [[r["step"], r["loss"]] for r in traj
                          if r["step"] % 10 == 0],
        "dice": [[r["phase"], r["epoch"], r["step"], r["mean_dice"],
                  r["dice"]] for r in vals],
        "sec_per_step_p50": float(np.median(step_s)),
        "sec_per_step_mean": float(np.mean(step_s)),
        "data_wait_p50": float(np.median(waits)),
        "data_wait_max": float(np.max(waits)),
        "peak_gib": float(max(peaks)) if peaks else None,
        **checks,
    }


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--dir", default=None,
                    help="work directory (cases, logs); a temporary one "
                         "by default")
    ap.add_argument("--augmentation", default="device",
                    help="Trainer augmentation mode (device/default/noaug)")
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the summary here")
    # the training process
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--phase", default="first", help=argparse.SUPPRESS)
    ap.add_argument("--record", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.child:
        return train_child(args)
    with tempfile.TemporaryDirectory() as tmp:
        args.dir = args.dir or tmp
        args.record = os.path.join(args.dir, "steps.jsonl")
        if os.path.exists(args.record):
            os.remove(args.record)
        t0 = time.perf_counter()
        if not os.path.isdir(os.path.join(args.dir, "fullres")):
            print("generating synthetic cases...", flush=True)
            make_cases(args.dir)
        t_data = time.perf_counter() - t0
        t0 = time.perf_counter()
        records = run_phases(args)
        summary = summarize(records, args)
        summary.update(data_s=t_data, wall_s=time.perf_counter() - t0)
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    if not (summary["resume_ok"] and summary["losses_finite"]):
        raise SystemExit("train_dynamics: resume or loss check failed")
    return summary


if __name__ == "__main__":
    main()
