"""Device-resident vector indexes.

Replaces the reference's hnsw_rs file store (lib/libmemex/src/storage/
local.rs) and its OpenSearch delegation (storage/opensearch.rs) with
Device-resident indexes:

- `FlatIndex`: exact brute-force cosine/MIPS over a fixed-capacity device
  buffer — the recall oracle and the small/medium-scale workhorse.
- `ShardedFlatIndex`: corpus sharded over a jax.sharding.Mesh axis;
  per-shard scoring under shard_map with a collective top-k merge
  (the memex analogue of TP/EP, SURVEY.md §2.3).
- `IVFIndex`: k-means partitioned index for 10M+ scale; queries route to
  nprobe clusters (expert-style routing).
- `ShardedIVFIndex`: IVF partitions sharded across the mesh — the
  100M-tier (clusters as experts, batch-union probe scan per shard,
  collective merge).
"""

from .flat import FlatIndex
from .sharded import ShardedFlatIndex
from .ivf import IVFIndex
from .sharded_ivf import ShardedIVFIndex

__all__ = ["FlatIndex", "ShardedFlatIndex", "IVFIndex", "ShardedIVFIndex"]
