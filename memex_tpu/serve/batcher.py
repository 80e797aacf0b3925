"""Request microbatching with a dispatch/complete pipeline.

Device throughput comes from batch: one encode+scan over Q=32 queries costs
barely more than Q=1 (the corpus read dominates). The batcher collects
concurrent requests for up to `max_wait_ms` (or until `max_batch`) and
executes them as one device call — queries to the same collection share a
single fused-kernel scan.

Pipelining: a serial collect→dispatch→fetch loop leaves the device idle
during each winner fetch; the two-stage mode (`run_batch_async`)
dispatches batch N+1 while batch N's fetch is in flight, and a small
completion pool overlaps the fetches themselves (device execution is
in-order, so results stay correct; per-client ordering holds because each
client blocks on its own future). Whether the pipeline beats plain serial
dispatch on a local host link is ROADMAP D5's question. In-flight batches
are semaphore-bounded so a slow device backpressures collection instead
of queueing unbounded.

Latency math: +max_wait_ms p50 cost buys ~Qx throughput under load; with
no concurrency the queue drains immediately after one wait window.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable

from ..log import get_logger
from ..metrics import METRICS

logger = get_logger(__name__)


@dataclass
class _Pending:
    item: Any
    future: Future = field(default_factory=Future)


class Microbatcher:
    """Generic batcher: batches collected within the wait window are run
    either synchronously (`run_batch(items) -> results`) or pipelined
    (`run_batch_async(items) -> finish`, where `finish() -> results` is
    executed in order on a completer thread)."""

    def __init__(self, run_batch: Callable[[list], list] | None = None,
                 max_batch: int = 32, max_wait_ms: float = 3.0,
                 name: str = "batch",
                 run_batch_async: Callable[[list], Callable[[], list]] | None = None,
                 pipeline_depth: int = 3, completer_threads: int = 2):
        assert (run_batch is None) != (run_batch_async is None), \
            "exactly one of run_batch / run_batch_async"
        self.run_batch = run_batch
        self.run_batch_async = run_batch_async
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.name = name
        self._pending: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._shutdown = False
        self._pool = None
        self._sem: threading.Semaphore | None = None
        if run_batch_async is not None:
            from concurrent.futures import ThreadPoolExecutor

            # Completion = one blocking winner fetch per batch; a single
            # completer caps batch rate at 1/fetch latency no matter how
            # fast dispatch is. Two fetch threads overlap the fetch
            # latency windows (the payloads are KB-scale); the semaphore
            # bounds total in-flight batches so a slow device
            # backpressures collection instead of queueing unbounded.
            self._sem = threading.Semaphore(pipeline_depth)
            self._pool = ThreadPoolExecutor(
                max_workers=completer_threads,
                thread_name_prefix=f"memex-{name}-complete")
        self._thread = threading.Thread(target=self._loop, name=f"memex-{name}", daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        p = _Pending(item)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("batcher is shut down")
            self._pending.append(p)
            self._wake.notify()
        return p.future

    def __call__(self, item: Any, timeout: float = 120.0):
        return self.submit(item).result(timeout=timeout)

    def close(self) -> None:
        with self._lock:
            self._shutdown = True
            self._wake.notify()
        self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def _collect(self) -> list[_Pending] | None:
        """Wait for work; returns a batch, or None on shutdown-and-drained."""
        import time as _time

        with self._lock:
            while not self._pending and not self._shutdown:
                self._wake.wait()
            if self._shutdown and not self._pending:
                return None
            # Collect until the window closes or the batch fills. A
            # single wait() would end on the FIRST notify (one more
            # submit), degenerating steady-load batches to ~2 items;
            # and when a backlog is already >= max_batch there is
            # nothing to wait for at all.
            deadline = _time.monotonic() + self.max_wait
            while (len(self._pending) < self.max_batch
                   and not self._shutdown):
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(remaining)
            batch = self._pending[: self.max_batch]
            self._pending = self._pending[self.max_batch :]
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            METRICS.inc(f"batcher.{self.name}.batches")
            METRICS.inc(f"batcher.{self.name}.items", len(batch))
            if self.run_batch_async is not None:
                self._sem.acquire()  # blocks at the pipeline-depth limit
                try:
                    import time as _t

                    _t0 = _t.perf_counter()
                    with METRICS.timer(f"batcher.{self.name}.dispatch"):
                        finish = self.run_batch_async([p.item for p in batch])
                    # Delta-able totals (the timer ring mixes history
                    # across workloads; stage telemetry needs deltas).
                    METRICS.inc(f"batcher.{self.name}.dispatch_us",
                                int((_t.perf_counter() - _t0) * 1e6))
                except Exception as exc:
                    self._sem.release()
                    logger.exception("batch %s dispatch failed", self.name)
                    for p in batch:
                        if not p.future.done():
                            p.future.set_exception(exc)
                    continue
                self._pool.submit(self._complete_one, batch, finish)
                continue
            try:
                from ..metrics import profile_trace

                with METRICS.timer(f"batcher.{self.name}"), \
                        profile_trace(f"batch.{self.name}"):
                    results = self.run_batch([p.item for p in batch])
                self._resolve(batch, results)
            except Exception as exc:
                logger.exception("batch %s failed", self.name)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def _complete_one(self, batch: list[_Pending], finish) -> None:
        try:
            import time as _t

            _t0 = _t.perf_counter()
            with METRICS.timer(f"batcher.{self.name}.complete"):
                results = finish()
            METRICS.inc(f"batcher.{self.name}.complete_us",
                        int((_t.perf_counter() - _t0) * 1e6))
            self._resolve(batch, results)
        except Exception as exc:
            logger.exception("batch %s completion failed", self.name)
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
        finally:
            self._sem.release()

    def _resolve(self, batch: list[_Pending], results: list) -> None:
        if len(results) != len(batch):
            raise RuntimeError(
                f"run_batch returned {len(results)} results for {len(batch)} items"
            )
        for p, r in zip(batch, results):
            p.future.set_result(r)


class SearchBatcher:
    """Batches (collection, query_text, limit) search requests: one encoder
    call for all queries in the window, one index scan per collection —
    dispatched pipelined (see Microbatcher)."""

    def __init__(self, runtime, max_batch: int = 32, max_wait_ms: float = 3.0):
        self.rt = runtime
        self._fused = None
        self._mb = Microbatcher(
            run_batch_async=self._dispatch, max_batch=max_batch,
            max_wait_ms=max_wait_ms, name="search",
        )

    def search(self, collection: str, query: str, limit: int, timeout: float = 120.0):
        return self._mb((collection, query, limit), timeout=timeout)

    def warmup(self, collection: str, k: int = 10,
               seq_lens: tuple[int, ...] = (32,)) -> int:
        """Pre-compile every fused executable this collection's index can
        hit through THIS batcher (serve startup / bench setup): all Q
        buckets up to the one covering max_batch — an unwarmed straggler
        bucket compiles inside a request (see FusedQueryPath.warmup)."""
        from .query_path import _Q_BUCKETS, FusedQueryPath, _bucket

        import numpy as np

        store = self.rt.store(collection)
        if self._fused is None:
            self._fused = FusedQueryPath(self.rt.engine)
        top = _bucket(self._mb.max_batch, _Q_BUCKETS)
        buckets = tuple(b for b in _Q_BUCKETS if b <= top)
        if self._fused.supports(store):
            return self._fused.warmup(store, k=k, seq_lens=seq_lens,
                                      q_buckets=buckets)
        # Non-fused device stores (IVF/mesh): their index executables
        # key on the query-batch bucket too; warm them through the same
        # search_batch path the dispatch loop uses. Remote/HNSW stores
        # have no device executables — skip (a remote warmup would fire
        # real HTTP traffic).
        index = getattr(store, "index", None)
        if index is None or getattr(index, "count", 0) == 0:
            return 0
        dim = getattr(store, "dim", None) or getattr(index, "dim", 0)
        n = 0
        for B in buckets:
            store.search_batch(np.zeros((B, dim), np.float32), k)
            n += 1
        logger.info("non-fused store warm: %d batch shapes", n)
        return n

    def close(self) -> None:
        self._mb.close()

    def _dispatch(self, items: list[tuple[str, str, int]]):
        """Stage 1: group by collection and queue the device work. Returns
        the stage-2 closure that fetches winners + hydrates ids."""
        import numpy as np

        from .query_path import FusedQueryPath

        if self._fused is None:
            self._fused = FusedQueryPath(self.rt.engine)
        # Group by collection; one device call per collection.
        by_col: dict[str, list[int]] = {}
        for i, (col, _, _) in enumerate(items):
            by_col.setdefault(col, []).append(i)
        fused_parts = []   # (idxs, store, dispatched)
        direct_parts = []  # (idxs, store) — non-fused stores, run in finish
        for col, idxs in by_col.items():
            store = self.rt.store(col)
            max_limit = max(items[i][2] for i in idxs)
            if self._fused.supports(store):
                disp = self._fused.dispatch(
                    store, [items[i][1] for i in idxs], max_limit)
                fused_parts.append((idxs, store, disp))
            else:
                direct_parts.append((idxs, store, max_limit))

        def finish() -> list:
            from ..store.base import SearchHit

            results: list = [None] * len(items)
            for idxs, store, disp in fused_parts:
                raw = disp.finish()
                doc_of = getattr(store, "_doc_of", {})
                for j, i in enumerate(idxs):
                    results[i] = [
                        SearchHit(id=sid, score=s, document_id=doc_of.get(sid))
                        for sid, s in raw[j]
                    ][: items[i][2]]
            vectors = None
            for idxs, store, max_limit in direct_parts:
                if vectors is None:
                    vectors = self.rt.engine.encode_batch(
                        [q for (_, q, _) in items])
                # Bucket Q for the non-fused path too: index executables
                # key on the (8-rounded) query-batch shape, so raw fill
                # sizes would mint up to 16 executables per store, each a
                # compile inside a request. Zero pad
                # rows score 0 everywhere and are sliced off.
                from .query_path import _Q_BUCKETS, _bucket

                B = _bucket(len(idxs), _Q_BUCKETS)
                qv = np.zeros((B, vectors.shape[1]), np.float32)
                qv[: len(idxs)] = [vectors[i] for i in idxs]
                batch_hits = store.search_batch(qv, max_limit)
                for j, i in enumerate(idxs):
                    results[i] = batch_hits[j][: items[i][2]]
            return results

        return finish
