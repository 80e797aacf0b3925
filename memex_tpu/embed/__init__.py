"""Embedding engine: batched on-device sentence encoding.

Replaces the reference's SentenceEmbedder (dedicated OS thread around a
libtorch model, lib/libmemex/src/llm/embedding.rs:83-151) with a
load-once, jit-compiled, shape-bucketed JAX encoder that data-parallelizes
batches over a jax.sharding.Mesh.
"""

from .engine import EmbeddingEngine

__all__ = ["EmbeddingEngine"]
