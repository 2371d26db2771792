"""Parallelism of the port over ``torch.distributed`` (counterpart of
``segmamba_tpu/parallel``): named meshes of ranks (``mesh``), starting the
ranks (``multihost``: ``torchrun`` or the local ``launch``), the
differentiable collectives (``comm``), tensor-parallel shards (``tp``) and
distributed evaluation (``eval``). The sequence-parallel scan is
``ops/scan_sharded.py``. The JAX package's pipeline parallelism
(``parallel/pp.py``) is not ported yet.
"""

from segmamba_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from segmamba_tpu_torch.parallel.tp import tp_shard, tp_specs

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_batch",
           "tp_shard", "tp_specs"]
