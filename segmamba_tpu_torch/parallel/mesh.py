"""Named meshes of ranks and the batch helpers.

Port of ``segmamba_tpu/parallel/mesh.py`` (``make_mesh``, ``data_sharding``,
``replicated``, ``shard_batch``; JAX's ``multihost.global_data_mesh`` is
``make_mesh()`` here and its ``make_global_batch`` is ``shard_batch``). In
JAX a mesh arranges devices on named axes and XLA inserts the collectives;
here a ``Mesh`` arranges the ranks of the default ``torch.distributed``
process group on named axes (row-major, as JAX's
``devices.reshape(shape)``) and holds, for this rank, one process
group per axis: the ranks that share every other coordinate. The caller
starts the ranks and the default group (``parallel.multihost``); building a
mesh is a collective call (every rank builds every group, in one order).

Every rank holds whole activations outside a sharded region, so a batch is
"sharded" by giving each rank its rows: ``shard_batch`` cuts this rank's
rows of the data axis out of a global batch (``--batch-size`` stays the
global batch, as in JAX). Ranks that share a data coordinate (on the
sequence or model axis) must hold the same rows: ``Mesh.replicas`` names
them and ``broadcast_tree`` hands one rank's batch (or checkpoint) to the
others.
"""

from __future__ import annotations

import itertools
import math
import typing

import torch
import torch.distributed as dist


class Mesh:
    """This rank's view of a mesh: ``axis_names``, ``shape``, its
    ``coords`` on each axis, and per axis the process ``group`` of the
    ranks that differ from it on that axis alone. ``device`` is the rank's
    device."""

    def __init__(self, axis_names, shape, device):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        grid = torch.arange(math.prod(self.shape)).reshape(self.shape)
        self.coords = tuple(int(c) for c in (grid == self.rank).nonzero()[0])
        self._groups = {}
        for a, name in enumerate(self.axis_names):
            # every rank creates every group of the axis, in the same order
            others = [range(s) for i, s in enumerate(self.shape) if i != a]
            for rest in itertools.product(*others):
                idx = list(rest)
                idx.insert(a, slice(None))
                ranks = [int(r) for r in grid[tuple(idx)].flatten()]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[name] = group
        # the ranks that share this rank's data coordinate
        self._replicas = None
        if math.prod(self.shape) > self.size("data"):
            if "data" not in self.axis_names:
                self._replicas = (dist.group.WORLD, 0)
            else:
                a = self.axis_names.index("data")
                for d in range(self.shape[a]):
                    ranks = [int(r) for r in grid.select(a, d).flatten()]
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._replicas = (group, ranks[0])

    def size(self, axis):
        """Ranks on ``axis``; 1 for an axis the mesh does not have."""
        return (self.shape[self.axis_names.index(axis)]
                if axis in self.axis_names else 1)

    def index(self, axis):
        """This rank's coordinate on ``axis`` (0 for a missing axis)."""
        return (self.coords[self.axis_names.index(axis)]
                if axis in self.axis_names else 0)

    def group(self, axis):
        return self._groups[axis]

    def replicas(self):
        """(group, global rank of its first member) of the ranks that share
        this rank's data coordinate, or None when a rank has none."""
        return self._replicas


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None,
              device=None) -> Mesh:
    """Build this rank's ``Mesh`` over the ranks of the default group.

    By default all ranks land on the first axis; ``shape`` (same length as
    ``axis_names``, product = rank count) gives true 2-D meshes, e.g.
    ``make_mesh(4, ("data", "seq"), shape=(2, 2))`` for DP x SP. Every rank
    must be in the mesh. ``device``: the rank's device (default: the
    current CUDA device when the default group is NCCL's, else the CPU).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "start the ranks with parallel.multihost")
    world = dist.get_world_size()
    if n_devices is not None:
        if n_devices > world:
            raise ValueError(f"requested {n_devices} devices, have {world}")
        if n_devices < world:
            raise ValueError(f"requested {n_devices} of {world} ranks; "
                             "every rank must be in the mesh")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} devices")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(axis_names, shape, device)


def data_sharding(mesh: Mesh, n_rows: int) -> slice:
    """The rows of an ``n_rows`` global batch that this rank holds: its
    contiguous share along the ``"data"`` axis (all of them without one)."""
    n = mesh.size("data")
    if n_rows % n:
        raise ValueError(f"global batch {n_rows} does not divide over "
                         f"{n} data ranks")
    per = n_rows // n
    i = mesh.index("data")
    return slice(i * per, (i + 1) * per)


def replicated(module):
    """Make ``module``'s parameters and buffers rank 0's (a broadcast over
    all ranks), as a replicated placement does in JAX; returns the
    module."""
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            dist.broadcast(t.data, 0)
    return module


class _Slot(typing.NamedTuple):
    """A tensor's place in a tree sent by ``broadcast_tree``."""
    index: int
    shape: tuple
    dtype: torch.dtype


def broadcast_tree(tree, src, group=None, device="cpu"):
    """Rank ``src``'s ``tree`` (nested dicts, lists and tuples of tensors
    and picklable leaves) on every rank of ``group``: its structure and
    leaves in one object broadcast, each tensor in a broadcast on
    ``device``, where every rank gets its tensors. Ranks other than ``src``
    pass ``tree=None``; ``src`` is a global rank."""
    device = torch.device(device)
    tensors = []

    def strip(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x.to(device).contiguous())
            return _Slot(len(tensors) - 1, tuple(x.shape), x.dtype)
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x

    box = [strip(tree) if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group)

    def fill(x):
        if isinstance(x, _Slot):
            if dist.get_rank() != src:
                tensors.append(torch.empty(x.shape, dtype=x.dtype,
                                           device=device))
            t = tensors[x.index]
            dist.broadcast(t, src, group=group)
            return t
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(fill(v) for v in x)
        return x

    return fill(box[0])


def shard_batch(batch, mesh: Mesh):
    """This rank's rows (``data_sharding``) of a global batch dict, on the
    mesh's device; entries without a batch dimension pass through."""
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape") or not v.shape:
            out[k] = v
            continue
        t = torch.as_tensor(v)[data_sharding(mesh, v.shape[0])]
        out[k] = t.to(mesh.device)
    return out
