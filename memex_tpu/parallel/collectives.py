"""Collective building blocks (used inside shard_map bodies).

These are XLA collectives, which XLA hands to NCCL on GPUs (SURVEY.md
§2.3 item 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def merge_topk_across(vals: jnp.ndarray, idx: jnp.ndarray, axis: str, k: int):
    """Inside shard_map: merge per-shard candidates into a global top-k.

    vals/idx: [Q, kk] local candidates with GLOBAL indices. all_gather over
    `axis` -> [Q, P*kk] -> exact top-k. Returns replicated (vals [Q,k],
    idx [Q,k]).
    """
    all_vals = jax.lax.all_gather(vals, axis, axis=1)  # [Q, P, kk]
    all_idx = jax.lax.all_gather(idx, axis, axis=1)
    q = all_vals.shape[0]
    all_vals = all_vals.reshape(q, -1)
    all_idx = all_idx.reshape(q, -1)
    mvals, order = jax.lax.top_k(all_vals, k)
    return mvals, jnp.take_along_axis(all_idx, order, axis=1)
