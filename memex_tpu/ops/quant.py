"""Row quantization and IVF routing helpers shared by the index tiers.

Plain `jax.numpy`/numpy: no kernels live here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def quantize_rows_int8(db: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[N, D] float -> ([N, D] int8, [N] f32 scales). Symmetric per-row."""
    absmax = jnp.max(jnp.abs(db), axis=1)
    scales = jnp.maximum(absmax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(db / scales[:, None]), -127, 127).astype(jnp.int8)
    return q, scales.astype(jnp.float32)


@jax.jit
def quantize_rows_int8_refine(db: jnp.ndarray):
    """Device twin of native_lib.np_quantize_rows_int8_refine: coarse int8
    codes PLUS int8 codes of the quantization residual (each per-row
    scaled) in one jitted pass, so f32 temporaries free inside the jit.
    Reconstruction q*s + rq*rs carries ~14 effective bits; only the
    refine-rerank gather reads rq/rs (index/flat.py, index/ivf.py
    refine=True). [N, D] f32 -> (int8 [N,D], f32 [N], int8 [N,D], f32 [N])."""
    q, scales = quantize_rows_int8(db)
    resid = db - q.astype(jnp.float32) * scales[:, None]
    rmax = jnp.maximum(jnp.max(jnp.abs(resid), axis=1), 1e-14)
    rscales = (rmax / 127.0).astype(jnp.float32)
    rq = jnp.clip(jnp.round(resid / rscales[:, None]), -127, 127
                  ).astype(jnp.int8)
    return q, scales, rq, rscales


def np_quantize_rows_int4(vectors) -> tuple[np.ndarray, np.ndarray]:
    """Host-side int4 pack: [M, D] f32 -> ([D/2, M] int8, [M] f32 scales).
    Byte b of row r holds 16*hi + lo, the codes of dims j and j + D/2."""
    v = np.asarray(vectors, np.float32)
    d = v.shape[1]
    assert d % 2 == 0, d
    absmax = np.abs(v).max(axis=1)
    scales = np.maximum(absmax, 1e-12) / 7.0
    codes = np.clip(np.round(v / scales[:, None]), -7, 7).astype(np.int32)
    lo, hi = codes[:, : d // 2], codes[:, d // 2 :]
    packed = (lo + 16 * hi).astype(np.int8)
    return np.ascontiguousarray(packed.T), scales.astype(np.float32)


def prune_probes(top_vals, probes, margin, dropped: int):
    """Margin prune of a routing table: a probe counts only while its
    centroid score is within `margin` of that query's best centroid;
    pruned probes become `dropped` (an out-of-range cluster id). margin
    may be traced; 4.0 keeps all (cosines span [-1, 1])."""
    keep = top_vals >= top_vals[:, :1] - margin
    return jnp.where(keep, probes, dropped)


def route_union(centroids, queries, nprobe: int,
                prune_margin: float | None = None):
    """Route a query batch and dedupe its probed clusters.

    (centroids [C, D], queries [Q, D]) -> (cluster_list [C] int32: active
    cluster ids ascending, inactive ids after; n_active [1] int32).
    Routing is f32 at HIGHEST precision: near-tied centroid scores would
    otherwise misroute probes. prune_margin (cosine units, opt-in) drops
    each query's long-tail probes (see `prune_probes`)."""
    C = centroids.shape[0]
    qc = jnp.einsum("qd,cd->qc", queries, centroids,
                    precision=jax.lax.Precision.HIGHEST)
    top_vals, probes = jax.lax.top_k(qc, nprobe)
    margin = jnp.asarray(4.0 if prune_margin is None else prune_margin,
                         jnp.float32)
    probes = prune_probes(top_vals, probes, margin, C)
    mask = jnp.zeros((C,), jnp.int32).at[probes.reshape(-1)].set(1, mode="drop")
    order = jnp.argsort(jnp.where(mask > 0, jnp.arange(C), C + jnp.arange(C)))
    return order.astype(jnp.int32), jnp.sum(mask, keepdims=True)
