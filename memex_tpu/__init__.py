"""memex_tpu — an accelerator-resident semantic-search & LLM-memory framework.

A ground-up rebuild of the capability surface of spyglass-search/memex
designed around one JAX device program per stage:

- host-side control plane: REST API (aiohttp), SQLite task queue + metadata
  (reference: lib/api, lib/worker, lib/libmemex/src/db)
- device-side data plane: batched Flax MiniLM sentence encoder under jit/pjit,
  a device-resident vector index (flat brute-force, IVF at scale) with a
  Pallas (Triton) fused dot-product+top-k kernel, sharded over a
  jax.sharding.Mesh with collective top-k merges
  (replaces reference's libtorch embeddings + hnsw_rs file index +
  OpenSearch delegation).
"""

__version__ = "0.1.0"

# UUID namespace for deterministic v5 ids, value-compatible with the
# reference (lib/libmemex/src/lib.rs:6) so that documents ingested by either
# system produce identical segment ids.
import uuid as _uuid

NAMESPACE = _uuid.UUID("5fdfe40a-de2c-11ed-bfa7-00155deae876")
