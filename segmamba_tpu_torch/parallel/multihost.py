"""Starting the ranks: from ``torchrun`` or from a local launcher.

Port of ``segmamba_tpu/parallel/multihost.py`` (``initialize_multihost``,
``is_main_process``; its ``global_data_mesh`` is ``parallel.mesh.make_mesh()``
and its ``make_global_batch`` is ``parallel.mesh.shard_batch``, since each
rank holds only its own rows). JAX runs one program over all devices;
torch runs one process per rank, joined by the default
``torch.distributed`` process group:

- under ``torchrun``, each process calls ``initialize_multihost(backend)``,
  which reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (and the rendezvous
  address) from the environment;
- ``launch(fn, world_size, ...)`` starts ``world_size`` local ranks itself
  (``spawn``, a ``FileStore`` in a fresh temporary directory: no port to
  collide with) and returns each rank's ``fn(rank, world_size, device,
  *args)``. The tests and ``chip_smoke.py`` use it; ``parallel/workers.py``
  holds their per-rank functions, so a spawned rank imports the port only.

The backend is always the caller's: ``"nccl"`` for one card a rank,
``"gloo"`` only when named (the CPU, or ranks that share one card, where
NCCL refuses to run two ranks on one device). Nothing falls back to
another backend or device.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _rank_device(backend, local_rank, device):
    """This rank's device: ``device`` when given (a CPU, or a card the
    ranks share), else ``cuda:LOCAL_RANK``, which must exist."""
    if device is not None:
        device = torch.device(device)
    elif local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own "
            f"({torch.cuda.device_count()} visible); name a shared device")
    else:
        device = torch.device("cuda", local_rank)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def initialize_multihost(backend, device=None):
    """Join the default process group from ``torchrun``'s environment.
    ``backend``: "nccl" or "gloo" (no default, no guessing). ``device``: a
    shared device to use instead of ``cuda:LOCAL_RANK``. Returns (rank,
    world size, device). A no-op join when the group exists already."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; one of {BACKENDS}")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = _rank_device(backend, local_rank, device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, device_id=dev if backend == "nccl" else None)
    return dist.get_rank(), dist.get_world_size(), dev


def is_main_process():
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank, world_size, store_path, backend, device, fn, args,
               results, threads, timeout_s):
    torch.set_num_threads(threads)
    try:
        dev = _rank_device(backend, rank, device)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        try:
            out = fn(rank, world_size, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # reported to the launcher, then the rank ends
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world_size, *args, backend="gloo", device=None,
           timeout_s=600, threads=1):
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` local
    ranks joined by ``backend``; return the ranks' results in rank order.

    ``fn`` must be importable (a module-level function: ranks are
    spawned). ``device``: the device every rank uses (e.g. "cpu", or
    "cuda:0" for ranks sharing one card over gloo); default
    ``cuda:<rank>``. ``threads``: torch's intra-op threads a rank. A rank
    that raises makes ``launch`` raise with its traceback; the ranks are
    stopped when ``launch`` returns or raises.
    """
    import multiprocessing

    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; one of {BACKENDS}")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="segmamba_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, os.path.join(tmp, "store"), backend, device, fn,
        args, results, threads, timeout_s))
        for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        got = {}
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=timeout_s)
            except queue_mod.Empty:
                raise TimeoutError(
                    f"launch: {world_size - len(got)} rank(s) gave no result "
                    f"in {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"launch: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
