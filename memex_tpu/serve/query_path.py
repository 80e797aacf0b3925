"""Fused query path: encoder forward + index scan in ONE XLA dispatch.

The two-step serving path (encode -> host fetch [Q, D] -> search -> host
fetch hits) pays two device round-trips. Composing both stages into one
jit keeps the query vectors on device and fetches only the [Q, k]
winners: one round-trip, and XLA fuses the encoder's epilogue into the
scan's prologue.

One executable is compiled per (batch bucket, seq bucket, capacity,
k bucket, storage dtype) — all small, enumerable sets. The index buffers
are passed as arguments (not captured), so ingest never forces a retrace
until a capacity doubling changes shapes.

Serving-latency rules:
  - EVERY bucket must be warmed before traffic: a straggler microbatch
    that buckets to an unwarmed Q shape compiles INSIDE the request.
    `warmup()` enumerates the bucket lattice; serve startup and the bench
    both call it.
  - k is bucketed too (`_K_BUCKETS`): the scan's top-k epilogue shape is
    static, so per-client `limit` values would otherwise each compile a
    fresh executable. Results are sliced to the requested k on host.
  - dispatch and fetch are split (`dispatch()` / `_Dispatched.finish()`)
    so the batcher can pipeline: dispatch batch N+1 while batch N's
    fetch is in flight (device execution is in-order).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..index.flat import FlatIndex, device_search
from ..ops.scan_topk import use_kernel
from ..embed.engine import seq_bucket
from ..log import get_logger
from ..models.minilm import MiniLMEncoder

logger = get_logger(__name__)

_Q_BUCKETS = (1, 8, 32, 64, 128, 256)
_K_BUCKETS = (16, 128)


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@partial(jax.jit, static_argnames=("enc_cfg", "k", "k_ret", "kernel",
                                   "mode"))
def _encode_and_search(params, ids, mask, buf, scales, alive, count, rbuf,
                       rbuf_scales, mean, *, enc_cfg, k: int, k_ret: int,
                       kernel: bool, mode: str):
    """Encoder forward + FlatIndex's own device search (index/flat.py
    `device_search`: scan, then the exact/refine rerank when k_ret > k),
    composed into one executable."""
    queries = MiniLMEncoder(enc_cfg).apply(params, ids, mask)  # unit vectors
    vals, rows = device_search(buf, scales, alive, count, queries, rbuf,
                               rbuf_scales, k=k, k_ret=k_ret, kernel=kernel,
                               mode=mode)
    if mean is not None:
        # Centered storage: the scan ranked by the (rank-equivalent)
        # residual score; restore true cosines with the query-constant
        # q.mean, on device, in the same dispatch.
        vals = vals + (queries @ mean)[:, None]
    return vals, rows


@dataclass
class _Dispatched:
    """An in-flight fused query batch: device work is queued, the winner
    fetch has not happened. `finish()` blocks on the fetch + hydrates."""

    parts: list  # [(vals_dev, rows_dev, ids_snapshot, count, n_texts, k)]

    def finish(self) -> list:
        from ..ops.host import fetch

        out = []
        for vals_d, rows_d, ids_snapshot, count, n_texts, k in self.parts:
            vals, rows = fetch(vals_d, rows_d)  # ONE round-trip per part
            for qi in range(n_texts):
                hits = []
                for v, r in zip(vals[qi], rows[qi]):
                    if v <= -1e29 or r >= count:
                        continue
                    hits.append((ids_snapshot[r], float(v)))
                out.append(hits[:k])
        return out


class FusedQueryPath:
    """Glues an EmbeddingEngine to TpuFlatStore-backed collections."""

    def __init__(self, engine):
        self.engine = engine

    def supports(self, store) -> bool:
        index = getattr(store, "index", None)
        return type(index) is FlatIndex and index.count > 0

    # -- dispatch / finish ---------------------------------------------------

    def dispatch(self, store, texts: list[str], k: int) -> _Dispatched:
        """Queue the fused encode+scan for `texts`; device work starts now,
        the blocking winner-fetch is deferred to `.finish()`."""
        cap = _Q_BUCKETS[-1]
        parts = []
        for s in range(0, len(texts), cap):
            parts.extend(self._dispatch_slice(store, texts[s : s + cap], k).parts)
        return _Dispatched(parts)

    def search_texts(self, store, texts: list[str], k: int):
        """texts -> per-text [(id, score)] through one device dispatch."""
        return self.dispatch(store, texts, k).finish()

    def _dispatch_slice(self, store, texts: list[str], k: int) -> _Dispatched:
        index: FlatIndex = store.index
        tok = self.engine.tokenizer
        encoded = [tok.encode(t, add_special_tokens=True)[: self.engine.max_seq_length]
                   for t in texts]
        # Shared bucketing with encode_single (embed/engine.seq_bucket):
        # the two paths must never disagree on compiled shapes.
        L = seq_bucket(max(len(e) for e in encoded), self.engine.max_seq_length)
        B = _bucket(len(texts), _Q_BUCKETS)
        ids = np.full((B, L), tok.pad_id, np.int32)
        mask = np.zeros((B, L), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        mask[len(texts):, 0] = 1  # pad rows: avoid 0/0 pooling

        # The lock is held THROUGH the dispatch, not just the argument
        # snapshot: a concurrent add() donates index.buf (jax marks the
        # old buffer deleted at the donor's call site), so dispatching
        # against a snapshot taken outside the lock can raise
        # "buffer donated" — and a compact() would renumber rows under
        # the id mapping. Once dispatched, in-order device execution
        # protects the computation; the blocking fetch happens unlocked.
        with getattr(store, "_lock", _NullLock()):
            count = index.count
            ids_snapshot = index.ids  # replaced (not mutated) by compaction
            vals, rows = self._dispatch_device(index, ids, mask, k, count)
        return _Dispatched([(vals, rows, ids_snapshot, count, len(texts), k)])

    def _dispatch_device(self, index: FlatIndex, ids, mask, k: int, count: int):
        """The jitted call itself; caller holds the store lock. k is
        bucketed, and k_ret follows FlatIndex.search, so rerank/refine
        stores keep their quality through the batcher."""
        k_eff = min(_bucket(k, _K_BUCKETS), count)
        rer = index.rerank or 0
        k_ret = min(max(k_eff, rer), count) if rer else k_eff
        return _encode_and_search(
            self.engine.params, jnp.asarray(ids), jnp.asarray(mask),
            index.scan_buf, index.scales,
            index.alive if index.dead else None, count,
            index.rbuf, index.rbuf_scales, _mean_dev(index),
            enc_cfg=self.engine.cfg, k=k_eff, k_ret=k_ret,
            kernel=use_kernel(index.mode, k_ret), mode=index.mode)

    # -- warmup --------------------------------------------------------------

    def warmup(self, store, k: int = 10, seq_lens: tuple[int, ...] = (32,),
               q_buckets: tuple[int, ...] | None = None) -> int:
        """Compile every (Q bucket, seq bucket) executable this store can
        hit before serving traffic: a single unwarmed straggler bucket
        costs an in-request compile. Returns the number of executables
        touched (cached ones load in seconds)."""
        if not self.supports(store):
            return 0
        index: FlatIndex = store.index
        tok = self.engine.tokenizer
        count = index.count
        n = 0
        last = None
        for L in seq_lens:
            for B in (q_buckets or _Q_BUCKETS):
                ids = np.full((B, L), tok.pad_id, np.int32)
                mask = np.zeros((B, L), np.int32)
                mask[:, 0] = 1
                with getattr(store, "_lock", _NullLock()):
                    last = self._dispatch_device(index, ids, mask, k, count)
                n += 1
        if last is not None:
            jax.block_until_ready(last)
        logger.info("fused query path warm: %d executables", n)
        return n


def _mean_dev(index: FlatIndex):
    """Device-resident copy of the centering mean, cached per index. The
    per-batch `jnp.asarray(mean)` re-upload is cheap (~1ms) but this also
    removes the host `.any()` sync from the serve loop entirely."""
    mean = index.mean
    if mean is None or not mean.any():
        return None
    cached = getattr(index, "_mean_dev_cache", None)
    if cached is not None and cached[0] is mean:
        return cached[1]
    dev = jnp.asarray(mean)
    index._mean_dev_cache = (mean, dev)
    return dev


class _NullLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
