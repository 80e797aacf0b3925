"""EmbeddingEngine — load-once, shape-bucketed, data-parallel encoder.

Reference hot spots being fixed (SURVEY.md §3):
  - model reloaded per ingest job and per query (lib/worker/src/tasks.rs:17,
    lib/api/src/endpoints/collections/handlers.rs:61) → params live on
    device for the process lifetime;
  - one-window-at-a-time encode → fixed-shape bucketed batches so XLA
    compiles a handful of executables and the tensor cores see large matmuls;
  - single CPU thread → batch axis sharded over every device on the mesh
    (pure data parallelism; MiniLM at 384 hidden fits trivially per chip).

Shape-bucket policy: sequence length is fixed per call-site (windows are
always `max_seq_length`; queries round up through `_SEQ_BUCKETS`), and the
batch dimension rounds up through power-of-two buckets capped at
`max_batch`, padding with zero-mask rows. Every (B, L) pair maps to one
cached XLA executable.
"""

from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..log import get_logger
from ..models.minilm import (
    MiniLMConfig,
    MiniLMEncoder,
    cast_params_to_compute,
    init_params,
    load_params,
)
from ..text import WordPieceTokenizer, encode_windows
from ..text.segment import window_token_ids

logger = get_logger(__name__)

_SEQ_BUCKETS = (32, 64, 128, 256, 512)


def seq_bucket(n: int, max_seq_length: int) -> int:
    """Padded sequence length for n tokens: the smallest _SEQ_BUCKET that
    fits, with max_seq_length ALWAYS the terminal bucket — a non-bucket
    value like 384 must still yield a buffer the (truncated-to-max) ids
    fit in. Shared by encode_single and the fused query path so compiled
    shapes can never disagree."""
    for b in _SEQ_BUCKETS:
        if b >= max_seq_length:
            break
        if n <= b:
            return b
    return max_seq_length


def _batch_bucket(n: int, max_batch: int) -> int:
    b = 8
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class EmbeddingEngine:
    """Thread-safe sentence-embedding front end.

    API parity with the reference SentenceEmbedder:
      encode(text)        -> (segments, [S, D] vectors)   (embedding.rs:137-142)
      encode_single(text) -> [D] vector                    (embedding.rs:144-151)
    plus `encode_batch(texts)` for pre-chunked inputs.
    """

    def __init__(
        self,
        model_dir: str | None = None,
        max_seq_length: int = 256,
        window_stride: int = 86,
        max_batch: int = 512,
        mesh: Mesh | None = None,
        data_axis: str = "data",
        seed: int = 0,
        fetch_dtype: str | None = None,
    ):
        self.max_seq_length = max_seq_length
        self.window_stride = window_stride
        self.max_batch = max_batch
        self.mesh = mesh
        self.data_axis = data_axis
        self._lock = threading.Lock()
        # Device->host transfer precision for the pooled vectors: the
        # [B, D] f32 fetch is 1.5 KB/window, and float16 halves it; unit-norm embeddings round-trip f16
        # with ~2.4e-4 relative error, an order below the int8 storage
        # tier's own quantization noise. Default stays float32 (bit-exact
        # golden parity); opt in per engine or via
        # MEMEX_ENCODE_FETCH_DTYPE=float16 for ingest-heavy deployments.
        if fetch_dtype is None:
            fetch_dtype = os.environ.get("MEMEX_ENCODE_FETCH_DTYPE", "float32")
        assert fetch_dtype in ("float32", "float16", "bfloat16"), fetch_dtype
        self.fetch_dtype = fetch_dtype

        if model_dir and model_dir != "random":
            self.cfg, params = load_params(model_dir)
            self.tokenizer = WordPieceTokenizer.from_pretrained_dir(model_dir)
            logger.info("loaded MiniLM checkpoint from %s", model_dir)
        else:
            self.tokenizer = WordPieceTokenizer()
            # Full MiniLM-L12 geometry (vocab 30522): the random encoder
            # costs what a real checkpoint costs; the fallback tokenizer
            # uses the first few hundred ids.
            self.cfg = MiniLMConfig()
            assert self.tokenizer.vocab_size <= self.cfg.vocab_size
            params = init_params(self.cfg, seed=seed)
            logger.info("initialized random MiniLM (hermetic mode, seed=%d)", seed)
        params = cast_params_to_compute(params, self.cfg)
        self.encoder = MiniLMEncoder(self.cfg)
        self.dim = self.cfg.hidden_size

        if mesh is not None:
            # Replicate params across the mesh; batch axis will be sharded.
            rep = NamedSharding(mesh, P())
            self.params = jax.device_put(params, rep)
            self._in_sharding = NamedSharding(mesh, P(data_axis, None))
            self._out_sharding = NamedSharding(mesh, P(data_axis, None))
            self._n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        else:
            self.params = jax.device_put(params)
            self._in_sharding = None
            self._out_sharding = None
            self._n_dev = 1

    def _jit_apply(self):
        """ONE jitted forward shared by every (batch, seq) bucket —
        jax.jit already caches an executable per concrete input shape, so
        a per-shape dict of fresh jit wrappers bought nothing."""
        fn = getattr(self, "_jit_fn", None)
        if fn is None:
            apply = self.encoder.apply
            if self.fetch_dtype != "float32":
                dt = jnp.dtype(self.fetch_dtype)

                def apply(p, i, m, _a=self.encoder.apply, _dt=dt):
                    # Cast ON DEVICE so the host fetch moves half the
                    # bytes (see fetch_dtype above).
                    return _a(p, i, m).astype(_dt)

            if self.mesh is not None:
                fn = jax.jit(
                    apply,
                    in_shardings=(None, self._in_sharding, self._in_sharding),
                    out_shardings=self._out_sharding,
                )
            else:
                fn = jax.jit(apply)
            self._jit_fn = fn
        return fn

    def _run(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Run one fixed-shape batch; returns float32 [B, D]."""
        out = self._jit_apply()(self.params, jnp.asarray(ids), jnp.asarray(mask))
        return np.asarray(out).astype(np.float32, copy=False)

    # -- batching ------------------------------------------------------------

    def _encode_padded(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Encode [N, L] in bucketed chunks of at most max_batch rows.

        All chunks are DISPATCHED before any result is fetched: dispatch
        is async and device execution is in-order, so the per-chunk
        device->host fetch overlaps the remaining chunks' forward passes
        instead of serializing with them. In-flight outputs are [B, D]
        each — a few hundred KB — so lookahead depth is not a memory
        concern."""
        N, L = ids.shape
        out = np.empty((N, self.dim), dtype=np.float32)
        jit_fn = self._jit_apply()
        if self.mesh is None and N >= 8 * self.max_batch:
            return self._encode_bulk(ids, mask, out)
        pending: list[tuple[int, int, object]] = []
        start = 0
        while start < N:
            take = min(self.max_batch, N - start)
            B = _batch_bucket(take, self.max_batch)
            # Keep B divisible by the mesh size so DP sharding is even.
            if self._n_dev > 1 and B % self._n_dev:
                B = ((B + self._n_dev - 1) // self._n_dev) * self._n_dev
            chunk_ids = np.zeros((B, L), dtype=np.int32)
            chunk_mask = np.zeros((B, L), dtype=np.int32)
            chunk_ids[:take] = ids[start : start + take]
            chunk_mask[:take] = mask[start : start + take]
            # Pad rows must still have >=1 unmasked token to avoid 0/0 in
            # pooling; [CLS]-only rows are discarded below anyway.
            chunk_mask[take:, 0] = 1
            pending.append((start, take, jit_fn(
                self.params, jnp.asarray(chunk_ids), jnp.asarray(chunk_mask))))
            start += take
        for s, take, dev in pending:
            out[s : s + take] = np.asarray(dev)[:take].astype(
                np.float32, copy=False)
        return out

    def _encode_bulk(self, ids: np.ndarray, mask: np.ndarray,
                     out: np.ndarray, phases: dict | None = None) -> np.ndarray:
        """Large-ingest path: upload FIXED-SIZE super-chunks (8 x
        max_batch rows each) and compute per-batch via an on-device
        dynamic_slice. The plain chunked path re-uploads 0.5MB per
        dispatch, and those transfers can serialize with compute.
        Super-chunks are a FIXED shape, so exactly one slice executable exists
        regardless of corpus size — an early version keyed the executable
        on the whole [N, L] upload and recompiled per distinct N.
        `phases` (bench telemetry) gains dispatch/sync/fetch seconds."""
        import functools
        import time as _time

        N, L = ids.shape
        B = self.max_batch
        SC = 8 * B
        fn = getattr(self, "_bulk_fn", None)
        if fn is None:
            apply = self.encoder.apply
            dt = (jnp.dtype(self.fetch_dtype)
                  if self.fetch_dtype != "float32" else None)

            @functools.partial(jax.jit, static_argnames=("b",))
            def fn(params, ids_dev, mask_dev, base, b):
                i = jax.lax.dynamic_slice_in_dim(ids_dev, base, b)
                m = jax.lax.dynamic_slice_in_dim(mask_dev, base, b)
                o = apply(params, i, m)
                return o.astype(dt) if dt is not None else o

            self._bulk_fn = fn
        t0 = _time.perf_counter()
        pending: list[tuple[int, int, object]] = []
        for sc in range(0, N, SC):
            n_here = min(SC, N - sc)
            sc_ids = np.zeros((SC, L), np.int32)
            sc_mask = np.zeros((SC, L), np.int32)
            sc_ids[:n_here] = ids[sc : sc + n_here]
            sc_mask[:n_here] = mask[sc : sc + n_here]
            sc_mask[n_here:, 0] = 1  # pad rows: avoid 0/0 pooling
            ids_dev = jnp.asarray(sc_ids)    # async: upload of super-chunk
            mask_dev = jnp.asarray(sc_mask)  # i+1 overlaps compute of i
            for base in range(0, n_here, B):
                pending.append((sc + base, min(B, n_here - base),
                                fn(self.params, ids_dev, mask_dev, base, B)))
        if phases is not None:
            phases["dispatch_s"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
            jax.block_until_ready(pending[-1][2])
            phases["device_sync_s"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
        for lo, take, dev in pending:
            out[lo : lo + take] = np.asarray(dev)[:take].astype(
                np.float32, copy=False)
        if phases is not None:
            phases["fetch_s"] = _time.perf_counter() - t0
        return out

    # -- public API ----------------------------------------------------------

    def _window_doc(self, text: str) -> tuple[list[str], list[list[int]]]:
        raw = self.tokenizer.encode(text, add_special_tokens=False)
        if not raw:
            raw = [self.tokenizer.unk_id]
        windows = window_token_ids(
            raw, self.tokenizer, self.max_seq_length, self.window_stride
        )
        return [self.tokenizer.decode(w) for w in windows], windows

    def encode(self, text: str) -> tuple[list[str], np.ndarray]:
        """Segment a document into overlapping token windows and embed every
        window (reference `encode`, embedding.rs:137-142 + segment_text
        :154-198). Returns (decoded segments, [S, D] unit vectors)."""
        return self.encode_many([text])[0]

    def encode_many(self, texts: list[str]) -> list[tuple[list[str], np.ndarray]]:
        """encode() over several documents with ALL their windows packed
        into one device-call stream — concurrent ingest tasks share
        dispatches instead of paying one round-trip each."""
        segmented = [self._window_doc(t) for t in texts]
        all_windows = [w for _, ws in segmented for w in ws]
        L = self.max_seq_length
        ids = np.full((len(all_windows), L), self.tokenizer.pad_id, dtype=np.int32)
        mask = np.zeros((len(all_windows), L), dtype=np.int32)
        for i, w in enumerate(all_windows):
            ids[i, : len(w)] = w
            mask[i, : len(w)] = 1
        with self._lock:
            vecs = self._encode_padded(ids, mask)
        out = []
        start = 0
        for segments, ws in segmented:
            out.append((segments, vecs[start : start + len(ws)]))
            start += len(ws)
        return out

    def encode_single(self, text: str) -> np.ndarray:
        """Truncate-and-embed one query (reference encode_single,
        embedding.rs:144-151). Uses the smallest seq bucket that fits, so
        short queries compile/execute on tiny shapes."""
        ids_list = self.tokenizer.encode(text, add_special_tokens=True)[: self.max_seq_length]
        L = seq_bucket(len(ids_list), self.max_seq_length)
        ids = np.full((1, L), self.tokenizer.pad_id, dtype=np.int32)
        mask = np.zeros((1, L), dtype=np.int32)
        ids[0, : len(ids_list)] = ids_list
        mask[0, : len(ids_list)] = 1
        with self._lock:
            return self._encode_padded(ids, mask)[0]

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        """Embed pre-chunked texts, one vector each ([N, D])."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        ids, mask = encode_windows(texts, self.tokenizer, self.max_seq_length)
        with self._lock:
            return self._encode_padded(ids, mask)
