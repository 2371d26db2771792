"""Per-rank programs for ``multihost.launch``: the port's side of the
parallel checks, run on every rank of a local world.

Each takes ``(rank, world_size, device, cases)`` with inputs as numpy
arrays (global arrays: each rank cuts its own share), runs the port's
parallel code on them, and returns numpy results that the caller holds
against a reference: the whole output, the inputs' gradients gathered, the
parameters' gradients reduced. They live in the port, so that a spawned
rank imports the port and torch only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from segmamba_tpu_torch.ops.scan_sharded import (
    causal_conv1d_sharded_local,
    mamba_inner_sharded,
    selective_scan_sharded,
)
from segmamba_tpu_torch.parallel import comm
from segmamba_tpu_torch.parallel.mesh import make_mesh, shard_batch
from segmamba_tpu_torch.parallel.tp import tp_gather_state, tp_shard

# the sharded operands (token axis 1) of each op
_SHARDED = {"scan": ("u", "delta", "B", "C", "z"), "inner": ("xz",),
            "conv": ("x",)}


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _local_op(op, a, kw, group):
    """One sharded op on this rank's tensors ``a``."""
    if op == "scan":
        return selective_scan_sharded(
            a["u"], a["delta"], a["A"], a["B"], a["C"], a.get("D"),
            a.get("z"), a.get("delta_bias"), group=group, **kw)
    if op == "inner":
        return mamba_inner_sharded(
            a["xz"], a["conv_weight"], a["conv_bias"], a["x_proj"],
            a["dt_proj"], a["dt_bias"], a["A"], a["D_skip"], group=group,
            **kw)
    # the conv alone, in local scan order: flipped shards under reverse
    reverse = kw.get("reverse", False)
    x = a["x"].flip(1) if reverse else a["x"]
    y = causal_conv1d_sharded_local(x, a["weight"], a["bias"], group,
                                    activation="silu", reverse=reverse)
    return y.flip(1) if reverse else y


def sharded_op_cases(rank, world_size, device, cases):
    """``cases``: dicts of ``op`` ("scan": ``selective_scan_sharded``,
    "inner": ``mamba_inner_sharded``, "conv": ``causal_conv1d_sharded_local``
    with the silu), ``inputs`` (global arrays by argument name), ``kw`` and
    ``cot`` (the output's cotangent). Returns per case {"out", "grads"}:
    the whole output and every input's gradient (sequences gathered,
    parameters summed over the ranks)."""
    group = dist.group.WORLD
    results = []
    for case in cases:
        sharded = _SHARDED[case["op"]]
        a = {}
        for name, v in case["inputs"].items():
            t = torch.tensor(v, device=device)
            if name in sharded:
                t = t.chunk(world_size, 1)[rank].contiguous()
            a[name] = t.requires_grad_()
        out = _local_op(case["op"], a, case["kw"], group)
        cot = torch.tensor(case["cot"], device=device).chunk(
            world_size, 1)[rank]
        (out * cot).sum().backward()
        grads = {}
        for name, t in a.items():
            g = t.grad
            if name in sharded:
                g = torch.cat(comm._all_gather(g, group), 1)
            else:
                g = g.clone()
                dist.all_reduce(g, group=group)
            grads[name] = _np(g)
        full = torch.cat(comm._all_gather(out.detach(), group), 1)
        results.append({"out": _np(full), "grads": grads})
    return results


def mamba_cases(rank, world_size, device, cases):
    """``MambaV3`` under sequence or tensor parallelism: ``cases`` are dicts
    of ``mode`` ("sp" over a ("seq",) mesh, "tp" over ("model",)),
    ``kw`` (the layer's arguments), ``state`` (its whole ``state_dict``,
    numpy), ``x`` and ``cot``. Returns per case the output, the input's
    gradient, the parameters' whole gradients by name and the form the
    layer took (``MambaV3.parallel``)."""
    from segmamba_tpu_torch.models.mamba import MambaV3

    meshes = {"sp": make_mesh(world_size, ("seq",), device=device),
              "tp": make_mesh(world_size, ("model",), device=device)}
    results = []
    for case in cases:
        mode, mesh = case["mode"], meshes[case["mode"]]
        layer = MambaV3(**case["kw"], mesh=mesh, seq_axis="seq",
                        model_axis="model" if mode == "tp" else None)
        layer.load_state_dict({k: torch.tensor(v)
                               for k, v in case["state"].items()})
        layer.to(device)
        sharded = tp_shard(layer, mesh) if mode == "tp" else set()
        x = torch.tensor(case["x"], device=device, requires_grad=True)
        y = layer(x)
        (y * torch.tensor(case["cot"], device=device)).sum().backward()
        grads = {n: p.grad for n, p in layer.named_parameters()}
        if sharded:
            grads = tp_gather_state(grads, mesh, sharded)
        results.append({"out": _np(y), "x_grad": _np(x.grad),
                        "grads": {n: _np(g) for n, g in grads.items()},
                        "form": layer.parallel(x.shape[1])})
    return results


def train_cases(rank, world_size, device, cases):
    """SegMamba train steps on a mesh: ``cases`` are dicts of ``axes`` and
    ``shape`` (the mesh), ``model_kw`` (``SegMamba``'s arguments),
    ``state`` (its whole ``state_dict``, numpy), the global ``image``
    (NCDHW) and ``label``, ``steps``, ``lr`` and ``num_classes``. Returns
    per case and step the loss, the gradient norm and the whole
    parameters after the update (gathered under tensor parallelism)."""
    from segmamba_tpu_torch.models.segmamba import SegMamba
    from segmamba_tpu_torch.train.train_state import (
        create_train_state,
        train_step,
    )

    results = []
    for case in cases:
        mesh = make_mesh(world_size, case["axes"], shape=case["shape"],
                         device=device)
        model_axis = "model" if "model" in case["axes"] else None
        model = SegMamba(**case["model_kw"], mesh=mesh, seq_axis="seq",
                         model_axis=model_axis)
        model.load_state_dict({k: torch.tensor(v)
                               for k, v in case["state"].items()})
        model.to(device)
        state = create_train_state(model, learning_rate=case["lr"],
                                   mesh=mesh, model_axis=model_axis)
        batch = shard_batch({"image": case["image"],
                             "label": case["label"]}, mesh)
        steps = []
        for _ in range(case["steps"]):
            m = train_step(state, batch, mesh=mesh,
                           num_classes=case["num_classes"])
            params, _ = state.whole_state()
            steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "params": {k: _np(v) for k, v in params.items()}})
        results.append(steps)
    return results


def eval_cases(rank, world_size, device, n_items):
    """``parallel.eval.eval_map`` over a ("data",) mesh of the world, for
    each count of ``n_items``: item k's result is 10 k and its rank."""
    from segmamba_tpu_torch.parallel.eval import eval_map

    mesh = make_mesh(world_size, ("data",), device=device)
    return [eval_map(lambda k: (10 * k, rank), list(range(n)), mesh)
            for n in n_items]


def train_cli(rank, world_size, device, argv):
    """``python -m segmamba_tpu_torch.train`` on this rank. Returns the
    trainer's step, epoch and last loss, and the main process's files in
    its model directory."""
    import os

    from segmamba_tpu_torch.train.__main__ import main

    trainer = main(list(argv))
    names = (sorted(os.listdir(trainer.model_save_path))
             if rank == 0 and os.path.isdir(trainer.model_save_path) else [])
    return {"global_step": trainer.global_step, "epoch": trainer.epoch,
            "last_loss": trainer.last_loss, "files": names,
            "batch_rows": trainer.batch_size // trainer.n_data}


def trainer_replicas(rank, world_size, device, case):
    """Two ``Trainer`` runs on a (data, seq) mesh of ``case["shape"]``
    with loader worker processes: an epoch with validation, then a resume
    for one more. Each rank keeps its own log directory (the main process
    alone finds a checkpoint there). Returns per run the losses and the
    sums of every batch the rank trained and validated on, its step and
    epoch, the files in its model directory and the whole parameters."""
    import os

    from segmamba_tpu_torch.data.dataset import (
        get_train_val_test_loader_from_train,
    )
    from segmamba_tpu_torch.models.segmamba import SegMamba
    from segmamba_tpu_torch.train.trainer import Trainer

    class Recording(Trainer):
        def _batches(self, loader):
            for batch in super()._batches(loader):
                self.seen.append((float(batch["image"].double().sum()),
                                  int(batch["label"].sum())))
                yield batch

        def on_step(self, metrics):
            self.losses.append(float(metrics["loss"]))

    mesh = make_mesh(world_size, ("data", "seq"), shape=case["shape"],
                     device=device)
    train_ds, val_ds, _ = get_train_val_test_loader_from_train(
        case["data_dir"], train_rate=0.5, val_rate=0.5, test_rate=0.0)
    logdir = os.path.join(case["logdir"], f"rank{rank}")
    runs = []
    for resume, epochs in ((False, 1), (True, 2)):
        model = SegMamba(**case["model_kw"],
                         generator=torch.Generator().manual_seed(0),
                         mesh=mesh, seq_axis="seq")
        trainer = Recording(
            model, logdir, max_epochs=epochs, batch_size=case["batch_size"],
            val_every=1, num_step_per_epoch=case["steps"],
            val_number=case["val_number"], patch_size=case["patch"],
            augmentation="noaug", num_workers=case["num_workers"], mesh=mesh,
            resume=resume, device=device)
        trainer.seen, trainer.losses = [], []
        trainer.train(train_ds, val_ds)
        files = (sorted(os.listdir(trainer.model_save_path))
                 if os.path.isdir(trainer.model_save_path) else [])
        runs.append({"losses": trainer.losses, "seen": trainer.seen,
                     "global_step": trainer.global_step,
                     "epoch": trainer.epoch, "files": files,
                     "params": {k: _np(v) for k, v in
                                model.state_dict().items()}})
    return runs


def many(rank, world_size, device, jobs):
    """Several of this module's programs in one world: ``jobs`` is a list
    of (function name, its cases); returns their results in order."""
    return [globals()[name](rank, world_size, device, cases)
            for name, cases in jobs]
