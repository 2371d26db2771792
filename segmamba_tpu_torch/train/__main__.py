"""BraTS training: SegMamba, SGD poly, CE over 4 classes.

Port of ``3_train.py`` (with its ``BraTSTrainer``): patch 128^3, batch 2,
250 steps per epoch, validation every 2 epochs on 100 patches with the
TC/WT/ET dice, keep-best checkpoints; the full-width BraTS model with
``remat="convs"``, bfloat16 compute and float32 parameters by default.

    python -m segmamba_tpu_torch.train --data-dir ./data/fullres/train \\
        --logdir ./logs/segmamba [--max-epochs 1000] [--device cuda]

``--augmentation device`` runs the augmentation chain on the card inside
the train step instead of in the loader processes. ``--device`` defaults
to ``cuda`` and never falls back to the CPU; ``--device cpu`` runs on the
CPU (small configurations only).

On several cards, one process a card under ``torchrun`` (NCCL; gloo with
``--device cpu``)::

    torchrun --nproc-per-node 4 -m segmamba_tpu_torch.train \
        --data-parallel --seq-parallel 2 ...

``--data-parallel`` and ``--seq-parallel N`` build the mesh as
``3_train.py:148-159`` does, from the launched world size: ("data", "seq")
of (world / N, N) with both, (1, N) with ``--seq-parallel`` alone (the
world must then be N: every rank is in the mesh), ("data",) over the world
with ``--data-parallel`` alone. ``--batch-size`` stays the global batch.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from segmamba_tpu_torch.data import get_train_val_test_loader_from_train
from segmamba_tpu_torch.data.planning import load_plan
from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.parallel.mesh import make_mesh
from segmamba_tpu_torch.parallel.multihost import initialize_multihost
from segmamba_tpu_torch.train.trainer import Trainer


def brats_groups(labels):
    """TC, WT, ET masks of a label map (1 necrosis, 2 edema, 3 enhancing)."""
    return [(labels == 1) | (labels == 3),
            (labels == 1) | (labels == 3) | (labels == 2),
            labels == 3]


class BraTSTrainer(Trainer):
    """Dice on the BraTS TC/WT/ET composites (3_train.py's BraTSTrainer)."""

    def validation_step(self, state, batch):
        image, label = self.get_input(batch)
        pred = self.predict(image).cpu().numpy()
        label = label.cpu().numpy()
        dices = []
        for p, g in zip(brats_groups(pred), brats_groups(label)):
            if p.sum() > 0 and g.sum() > 0:
                dices.append(float(2.0 * (p & g).sum() / (p.sum() + g.sum())))
            elif p.sum() == 0 and g.sum() == 0:
                dices.append(1.0)
            else:
                dices.append(0.0)
        return dices

    def validation_end(self, state, val_outputs):
        tc, wt, et = np.asarray(val_outputs).mean(axis=0)
        mean_dice = float((tc + wt + et) / 3)
        self._print(f"dices: tc={tc:.4f} wt={wt:.4f} et={et:.4f} "
                    f"mean={mean_dice:.4f}")
        for k, v in [("tc", tc), ("wt", wt), ("et", et),
                     ("mean_dice", mean_dice)]:
            self._log(k, v, self.epoch)
        self.save_checkpoints(state, mean_dice)
        return mean_dice


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default="./data/fullres/train")
    ap.add_argument("--logdir", default="./logs/segmamba")
    ap.add_argument("--max-epochs", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--val-every", type=int, default=2)
    ap.add_argument("--steps-per-epoch", type=int, default=250)
    ap.add_argument("--val-number", type=int, default=100)
    ap.add_argument("--patch", type=int, nargs=3, default=[128, 128, 128])
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--loss", default="ce", choices=["ce", "dice_ce"])
    ap.add_argument("--augmentation", default="default",
                    choices=["default", "device", "nomirror", "onlymirror",
                             "onlyspatial", "noaug"],
                    help="default: the host chain in the loader processes; "
                         "device: the same chain on the card inside the "
                         "train step (the loaders only crop); the others: "
                         "host chains with fewer transforms")
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    # model-size overrides (small runs); defaults = the BraTS recipe
    ap.add_argument("--feats", type=int, nargs=4, default=[48, 96, 192, 384])
    ap.add_argument("--depths", type=int, nargs=4, default=[2, 2, 2, 2])
    ap.add_argument("--hidden-size", type=int, default=768)
    ap.add_argument("--num-slices", type=int, nargs=4,
                    default=[64, 32, 16, 8])
    ap.add_argument("--split", type=float, nargs=3, default=[0.7, 0.1, 0.2],
                    help="train/val/test fractions (seed-42 shuffle)")
    ap.add_argument("--print-config", action="store_true",
                    help="print the resolved run config and exit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-parallel", action="store_true",
                    help="data parallelism over the launched ranks")
    ap.add_argument("--seq-parallel", type=int, default=1, metavar="N",
                    help="shard the Mamba layers' tokens over N ranks")
    ap.add_argument("--plan", default=None, metavar="PLAN_JSON")
    return ap


def apply_plan(args):
    """Take the patch from a dataset plan (``preprocess``'s
    ``data_analysis_result.json``), rounded down to multiples of 32 (at
    least 32) for the model, and the slice counts from its depth."""
    plan = load_plan(args.plan)
    patch = [max(32, (int(p) // 32) * 32) for p in plan["patch_size"]]
    print(f"plan patch_size {plan['patch_size']} -> model patch {patch}")
    args.patch = patch
    args.num_slices = [max(1, patch[0] // (2 ** (i + 1))) for i in range(4)]


def mesh_shape(args, world):
    """({axis: ranks}, or None for one process) of ``--data-parallel`` /
    ``--seq-parallel`` over ``world`` launched ranks (3_train.py:148-159)."""
    sp = args.seq_parallel
    if sp > 1:
        if world % sp:
            raise SystemExit(f"--seq-parallel {sp} does not divide "
                             f"{world} devices")
        if world // sp > 1 and not args.data_parallel:
            raise SystemExit(f"--seq-parallel {sp} on {world} ranks needs "
                             "--data-parallel: every rank is in the mesh")
        return {"data": world // sp, "seq": sp}
    if args.data_parallel:
        return {"data": world}
    if world != 1:
        raise SystemExit(f"{world} ranks launched: pass --data-parallel or "
                         "--seq-parallel")
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.plan:
        apply_plan(args)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    shape = mesh_shape(args, world)
    if args.print_config:
        print(json.dumps({"patch": list(args.patch),
                          "num_slices": list(args.num_slices),
                          "lr": args.lr, "loss": args.loss,
                          "dtype": args.dtype, "device": args.device,
                          "mesh": shape}))
        return None
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    mesh = None
    if shape is not None:
        _, _, device = initialize_multihost(
            "nccl" if device.type == "cuda" else "gloo",
            device="cpu" if device.type == "cpu" else None)
        mesh = make_mesh(world, tuple(shape), shape=tuple(shape.values()),
                         device=device)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = SegMamba(in_chans=4, out_chans=4, depths=tuple(args.depths),
                     feat_size=tuple(args.feats),
                     hidden_size=args.hidden_size,
                     num_slices_list=tuple(args.num_slices), dtype=dtype,
                     remat="convs",
                     generator=torch.Generator().manual_seed(args.seed),
                     mesh=mesh, seq_axis="seq")
    trainer = BraTSTrainer(
        model, args.logdir, max_epochs=args.max_epochs,
        batch_size=args.batch_size, val_every=args.val_every,
        num_step_per_epoch=args.steps_per_epoch, val_number=args.val_number,
        patch_size=tuple(args.patch),
        augmentation=(True if args.augmentation == "default"
                      else args.augmentation),
        learning_rate=args.lr, scheduler_type="poly", loss=args.loss,
        num_classes=4, num_workers=args.num_workers, mesh=mesh,
        seed=args.seed, resume=args.resume, device=device)
    train_ds, val_ds, _ = get_train_val_test_loader_from_train(
        args.data_dir, train_rate=args.split[0], val_rate=args.split[1],
        test_rate=args.split[2])
    trainer.train(train_ds, val_ds)
    return trainer


if __name__ == "__main__":
    main()
