"""Multi-process parallelism: counterpart of bem_tpu/parallel (one process
a rank over ``torch.distributed``; see mesh.py)."""

from .context import context_parallel_linear_scan
from .mesh import (Mesh, batch_sharding, init_dist, make_mesh, replicate, replicated_sharding,
                   shard_batch, spawn)
from .spatial import spatial_apply, spatial_sharding

__all__ = ["Mesh", "batch_sharding", "context_parallel_linear_scan", "init_dist", "make_mesh",
           "replicate", "replicated_sharding", "shard_batch", "spatial_apply", "spatial_sharding",
           "spawn"]
