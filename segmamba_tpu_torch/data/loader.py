"""Host-side parallel batch pipeline feeding the card.

A copy of ``segmamba_tpu/data/loader.py``: worker processes each own a
``PatchSampler`` + transform chain and push finished batches into a
bounded queue; the consumer side is a fixed-length iterator per epoch.
Three differences: batches leave in the port's layout (image NCDHW
float32, label (B, Z, Y, X) int64); workers start with the ``spawn``
method (the trainer's process has threads and a CUDA context, which
``fork`` would copy half-made), so the sampler and the transform are
pickled to them; and a worker puts each batch's arrays in shared memory
(torch's CPU tensors), so the queue carries handles, not bytes.

Through a pipe, a 2 x 4 x 128^3 batch is 84 MB that the trainer's
prefetch thread reads in pipe-sized chunks and unpickles, contending for
the interpreter lock with the thread that launches the train step: on an
H100 the step took 1.6-2.3 s with four workers against 0.59 s with the
batches made inline. The arrays come out as numpy views of the shared
memory.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import threading
import time

import numpy as np
import torch
import torch.multiprocessing  # noqa: F401  (tensors cross queues by handle)


def _shared(batch):
    """The batch's arrays copied into shared-memory CPU tensors."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype)
            t.share_memory_()
            t.numpy()[...] = v
            v = t
        out[k] = v
    return out


def _unshared(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def _worker_loop(sampler, transform, out_queue, seed, stop_event):
    rng = np.random.default_rng(seed)
    sampler.rng = rng
    while not stop_event.is_set():
        batch = sampler.generate_train_batch()
        if transform is not None:
            batch = transform(batch, rng)
        batch = _shared(DataLoader._to_device_layout(batch))
        while not stop_event.is_set():
            try:
                out_queue.put(batch, timeout=0.5)
                break
            except queue_mod.Full:
                continue


class DataLoader:
    """num_workers producer processes -> bounded queue -> fixed-len iterator.

    With ``num_workers=0`` everything runs inline (deterministic tests).
    """

    def __init__(self, sampler, transform=None, num_workers=8,
                 num_cached=6, seed=42, steps_per_epoch=250,
                 use_processes=True):
        self.sampler = sampler
        self.transform = transform
        self.num_workers = num_workers
        self.num_cached = num_cached
        self.seed = seed
        self.steps_per_epoch = steps_per_epoch
        self.use_processes = use_processes
        self._workers = []
        self._queue = None
        self._stop = None
        self._rng = np.random.default_rng(seed)

    # -- lifecycle --------------------------------------------------------

    def start(self):
        if self.num_workers <= 0 or self._workers:
            return
        if self.use_processes:
            ctx = mp.get_context("spawn")
            self._queue = ctx.Queue(maxsize=self.num_cached)
            self._stop = ctx.Event()
            make = ctx.Process
        else:
            self._queue = queue_mod.Queue(maxsize=self.num_cached)
            self._stop = threading.Event()
            make = threading.Thread
        for i in range(self.num_workers):
            w = make(target=_worker_loop,
                     args=(self.sampler, self.transform, self._queue,
                           self.seed + i, self._stop),
                     daemon=True)
            w.start()
            self._workers.append(w)

    def stop(self):
        """Stop the workers. A worker may be in the middle of a batch's
        augmentation (seconds of scipy): after a short grace in which the
        queue is drained (a worker blocked flushing it could not exit), a
        process still running is terminated; the queue is dropped with
        it."""
        if self._stop is not None:
            self._stop.set()
        deadline = time.monotonic() + 1.0
        while (any(w.is_alive() for w in self._workers)
               and time.monotonic() < deadline):
            try:
                self._queue.get(timeout=0.05)
            except queue_mod.Empty:
                pass
            except (OSError, EOFError):
                pass    # a batch whose worker has exited: its memory is gone
        for w in self._workers:
            if hasattr(w, "terminate") and w.is_alive():
                w.terminate()
            w.join(timeout=5.0)
        self._workers = []
        self._queue = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- iteration --------------------------------------------------------

    def _next_batch(self):
        if self.num_workers <= 0:
            batch = self.sampler.generate_train_batch()
            if self.transform is not None:
                batch = self.transform(batch, self._rng)
            return self._to_device_layout(batch)
        while True:
            try:
                return _unshared(self._queue.get(timeout=5.0))
            except queue_mod.Empty:
                dead = [w for w in self._workers if not w.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} data worker(s) died; see the "
                        "workers' stderr") from None

    @staticmethod
    def _to_device_layout(batch):
        """{'data': (B, C, Z, Y, X), 'seg': (B, 1, Z, Y, X)} host batch ->
        {'image': float32 NCDHW, 'label': int64 (B, Z, Y, X)}."""
        out = {"image": np.ascontiguousarray(batch["data"], np.float32)}
        if "seg" in batch:
            out["label"] = batch["seg"][:, 0].astype(np.int64)
        if "keys" in batch:
            out["keys"] = batch["keys"]
        return out

    def __iter__(self):
        self.start()
        for _ in range(self.steps_per_epoch):
            yield self._next_batch()

    def __len__(self):
        return self.steps_per_epoch
