"""Parallelism toolkit: meshes, collectives, multi-host init.

The reference has no distributed layer at all (SURVEY.md §2.3); these are
first-class designs here:
  - `mesh`: device-mesh construction + sharding helpers (DP over batch for
    the encoder, shard axis for the index);
  - `collectives`: shard-local top-k + all_gather merge building blocks
    used by ShardedFlatIndex;
  - `distributed`: jax.distributed bring-up for multi-host serving.
"""

from .mesh import local_mesh, replicated, row_sharded
from .collectives import merge_topk_across
from .distributed import init_multihost

__all__ = [
    "local_mesh",
    "replicated",
    "row_sharded",
    "merge_topk_across",
    "init_multihost",
]
