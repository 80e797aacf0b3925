"""Device-backed vector stores wrapping the index tier (the `tpu://`
schemes and `Tpu*Store` names are kept as user-facing names).

One store per collection. The index stays resident (device HBM) for the
process lifetime; `checkpoint()` persists to the collection dir, and
construction restores from the latest checkpoint when present — replacing
the reference's save-everything-per-insert / load-everything-per-query
cycle (lib/libmemex/src/storage/local.rs:62-69, storage/mod.rs:107-121).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..index.flat import FlatIndex
from ..index.ivf import IVFIndex
from ..log import get_logger
from .base import SearchHit, VectorData

logger = get_logger(__name__)


def _normalize(vectors: np.ndarray) -> np.ndarray:
    from ..native_lib import np_normalize_rows

    return np_normalize_rows(np.atleast_2d(np.asarray(vectors, np.float32)))


class TpuFlatStore:
    """Flat exact store (the default tier)."""

    # Maintenance scheduling (new vs reference): when the runtime wires
    # `on_maintenance`, O(corpus) work (retrains, tombstone compaction)
    # is enqueued as a worker Maintain task instead of running inline on
    # whichever request tripped the trigger. Class attributes so every
    # store subclass inherits them without __init__ changes.
    on_maintenance = None            # callable(collection, reason) | None
    _maintenance_last = 0.0          # time-windowed dedup, not a latch:
    #                                  a failed Maintain task must not
    #                                  suppress scheduling forever

    def request_maintenance(self, reason: str) -> bool:
        """Schedule background maintenance; returns True if scheduled (or
        recently requested — the DB dedups harder via has_pending). False
        = no scheduler wired; caller decides whether to do the work inline
        (standalone/library mode)."""
        cb = self.on_maintenance
        if cb is None:
            return False
        import time as _time

        now = _time.monotonic()
        if now - self._maintenance_last < 5.0:
            return True
        self._maintenance_last = now
        try:
            cb(self.collection, reason)
        except Exception:
            logger.exception("maintenance scheduling failed for %s",
                             self.collection)
            self._maintenance_last = 0.0
            return False
        return True

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384,
                 dtype: str | None = None, **kw):
        self.collection = collection
        self.dim = dim
        self._lock = threading.Lock()
        self._path = None
        if dtype is None:
            dtype = os.environ.get("MEMEX_INDEX_DTYPE", "float32")
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.flat")
        if self._path and FlatIndex.exists(self._path):
            self.index = FlatIndex.load(self._path, **kw)
            logger.info("restored collection %s (%d vectors)", collection, self.index.count)
        else:
            self.index = FlatIndex(dim=dim, dtype=dtype, **kw)
        self._doc_of: dict[str, str] = {}

    @property
    def count(self) -> int:
        return self.index.count - self.index.dead

    def add_vectors(self, data: list[VectorData]) -> None:
        if not data:
            return
        vecs = _normalize(np.stack([d.vector for d in data]))
        ids = [d.id for d in data]
        with self._lock:
            self.index.add(vecs, ids)
            for d in data:
                self._doc_of[d.id] = d.document_id

    def search(self, vector: np.ndarray, limit: int) -> list[SearchHit]:
        return self.search_batch(np.asarray(vector)[None, :], limit)[0]

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        vecs = _normalize(np.atleast_2d(vectors))
        with self._lock:
            raw = self.index.search(vecs, limit)
        return [
            [SearchHit(id=sid, score=score, document_id=self._doc_of.get(sid)) for sid, score in hits]
            for hits in raw
        ]

    def delete(self, ids: list[str]) -> int:
        with self._lock:
            n = self.index.delete(ids)
            for sid in ids:
                self._doc_of.pop(sid, None)
            return n

    def delete_all(self) -> None:
        with self._lock:
            self.index.delete_all()
            self._doc_of.clear()
            if self._path:
                type(self.index).remove_checkpoint(self._path)

    def checkpoint(self) -> None:
        if self._path:
            with self._lock:
                self.index.save(self._path)


class TpuIVFStore(TpuFlatStore):
    """IVF-tier store: same surface; build/rebuild exposed for bulk loads."""

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384,
                 n_clusters: int = 1024, nprobe: int = 64, **kw):
        self.collection = collection
        self.dim = dim
        self._lock = threading.Lock()
        self._path = None
        # prune_target=<floor> (URI option): auto-calibrate prune_margin
        # on the first search after each (re)build instead of hand-tuning
        # it — the right margin is corpus-dependent (the 10M bench sweep
        # and the unit fixtures disagree by 2x on the same recall floor).
        # prune_metric=recall calibrates against a full-probe baseline
        # (recall-vs-exact, routing loss included) instead of overlap vs
        # the unpruned nprobe search.
        # recall_target=<floor> goes further: jointly calibrates
        # (nprobe, prune_margin) — on anisotropic corpora the configured
        # nprobe itself can cap recall below the floor, and no margin can
        # lift it (ivf.calibrate_operating_point).
        self._prune_target = kw.pop("prune_target", None)
        self._prune_metric = str(kw.pop("prune_metric", "overlap"))
        self._recall_target = kw.pop("recall_target", None)
        self._calibrated = False
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.ivf")
        if self._path and IVFIndex.exists(self._path):
            self.index = IVFIndex.load(self._path, n_clusters=n_clusters, nprobe=nprobe, **kw)
            logger.info("restored IVF collection %s (%d vectors, trained=%s)",
                        collection, self.index.count, self.index.centroids is not None)
        else:
            self.index = IVFIndex(dim=dim, n_clusters=n_clusters, nprobe=nprobe, **kw)
        self._doc_of: dict[str, str] = {}

    def build(self, data: list[VectorData]) -> None:
        vecs = _normalize(np.stack([d.vector for d in data]))
        with self._lock:
            self.index.build(vecs, [d.id for d in data])
            for d in data:
                self._doc_of[d.id] = d.document_id
            self._calibrated = False

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        self._maybe_calibrate()
        return super().search_batch(vectors, limit)

    def _maybe_calibrate(self) -> None:
        """Lazy one-shot calibration (per build generation): runs on the
        first search once a cluster table exists — at build time the
        serving batch shapes are not warm yet, and spill-only collections
        have nothing to prune."""
        if (self._prune_target is None and self._recall_target is None) \
                or self._calibrated:
            return
        with self._lock:
            if self._calibrated or self.index.data is None:
                return
            if self._recall_target is not None:
                pt = self.index.calibrate_operating_point(
                    target_recall=self._recall_target)
                self._calibrated = True
                logger.info("ivf %s: operating point calibrated to %s "
                            "(recall target %.2f)",
                            self.collection, pt, self._recall_target)
                return
            m = self.index.calibrate_margin(
                target_overlap=self._prune_target,
                target_metric=self._prune_metric)
            self._calibrated = True
            logger.info("ivf %s: prune_margin calibrated to %s (target %.2f)",
                        self.collection, m, self._prune_target)

    @property
    def needs_recovery(self) -> bool:
        """True when the loaded checkpoint skipped its device-built base
        (index/ivf.py save policy) — runtime.store() re-streams the rows
        from SQL."""
        return getattr(self.index, "needs_recovery", False)

    def recovered(self) -> None:
        self.index.needs_recovery = False

    def add_vectors(self, data: list[VectorData]) -> None:
        super().add_vectors(data)
        if getattr(self, "_recovering", False):
            return  # one rebuild at the end of recovery, not per batch
        # Amortized maintenance once the spill outgrows 20% of the corpus
        # (or 4096 rows): stream spill rows into the existing partitions in
        # place (fold_spill — O(spill)); retrain from scratch only when the
        # buckets are too full to absorb them (rebuild — O(corpus)).
        spill = self.index.spill.count
        total = max(self.index.count, 1)
        if spill > 4096 or (total > 1024 and spill * 5 > total):
            folded = 0
            if self.index.dtype == "int8" and self.index.data is not None:
                with self._lock:
                    folded = self.index.fold_spill()
            left = self.index.spill.count
            if left > 4096 or (total > 1024 and left * 5 > total):
                # Prefer the worker queue (O(corpus) retrain off this
                # request); rebuild inline only in standalone/library mode.
                if not self.request_maintenance(
                        f"spill growth ({left}/{total})"):
                    logger.info(
                        "ivf %s: auto-rebuild (folded=%d spill=%d total=%d)",
                        self.collection, folded, left, total)
                    self.rebuild()
            elif folded:
                logger.info("ivf %s: folded %d spill rows in place",
                            self.collection, folded)

    def rebuild(self) -> None:
        with self._lock:
            self.index.rebuild()
            self._maintenance_last = 0.0
            if self._prune_target is not None or self._recall_target is not None:
                # Partitions changed; the old operating point is stale.
                self.index.prune_margin = None
                self._calibrated = False

    def delete(self, ids: list[str]) -> int:
        n = super().delete(ids)
        # Delete churn bounds: tombstones stay in `_deleted` until a
        # rebuild (a fold must not un-mark them — dup table copies), and
        # every tombstone widens the search over-fetch (kk = k + dead).
        # Past 25% dead the over-fetch grows costly, so rebuild — which
        # drops tombstoned rows and clears the set — mirroring FlatIndex's
        # compact cadence.
        if n and not getattr(self, "_recovering", False):
            dead = len(self.index._deleted)
            if dead > 256 and dead * 4 > max(self.index.count, 1):
                if not self.request_maintenance(
                        f"delete churn ({dead} tombstones)"):
                    logger.info("ivf %s: delete-churn rebuild (%d tombstones)",
                                self.collection, dead)
                    self.rebuild()
        return n

    @property
    def count(self) -> int:
        return self.index.count

    def checkpoint(self) -> None:
        """Persist centroids + packed clusters + spill (restores without
        re-running k-means; was a silent no-op before round 2)."""
        if self._path:
            with self._lock:
                self.index.save(self._path)


class TpuMeshStore(TpuFlatStore):
    """Mesh-sharded store: corpus rows distributed over every local device
    (the `tpu+mesh://` scheme) with collective top-k merge — the scale-out
    answer that replaces the reference's OpenSearch delegation
    (lib/libmemex/src/storage/opensearch.rs; SURVEY.md §2.2)."""

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384,
                 capacity_per_shard: int = 65536, **kw):
        import jax
        import numpy as _np
        from jax.sharding import Mesh

        from ..index.sharded import ShardedFlatIndex

        self.collection = collection
        self.dim = dim
        self._lock = threading.Lock()
        self._path = None
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.mesh")
        mesh = Mesh(_np.array(jax.devices()), ("shard",))
        self.index = ShardedFlatIndex(
            dim=dim, mesh=mesh, capacity_per_shard=capacity_per_shard, **kw
        )
        self._doc_of: dict[str, str] = {}
        if self._path and os.path.exists(self._path + ".meta.json"):
            n = self.index.restore(self._path)
            logger.info("restored mesh collection %s (%d vectors)", collection, n)

    @property
    def count(self) -> int:
        return self.index.count

    def checkpoint(self) -> None:
        """Incremental: moves only rows added since the last checkpoint
        (ShardedFlatIndex segment log over the host shadow — zero device
        fetch)."""
        if not self._path:
            return
        with self._lock:
            self.index.save(self._path)


class TpuMeshIVFStore(TpuFlatStore):
    """Mesh-sharded IVF store (`tpu+ivf+mesh://`) — the 100M-tier scheme:
    k-means partitions sharded over every local device, batch-union probe
    scan per shard, collective top-k merge (index/sharded_ivf.py). The
    scale-out answer that replaces the reference's OpenSearch delegation
    (lib/libmemex/src/storage/mod.rs:122-133) with the index itself
    spanning the mesh."""

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384,
                 n_clusters: int = 1024, nprobe: int = 64, **kw):
        import jax
        import numpy as _np
        from jax.sharding import Mesh

        from ..index.sharded_ivf import ShardedIVFIndex

        self.collection = collection
        self.dim = dim
        self._lock = threading.Lock()
        self._path = None
        # Same lazy prune_margin / operating-point auto-calibration as
        # TpuIVFStore (the margin is a dynamic scalar in the SPMD
        # executable; each ladder nprobe is one cached executable).
        self._prune_target = kw.pop("prune_target", None)
        self._prune_metric = str(kw.pop("prune_metric", "overlap"))
        self._recall_target = kw.pop("recall_target", None)
        self._calibrated = False
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.ivfmesh")
        mesh = Mesh(_np.array(jax.devices()), ("shard",))
        self.index = ShardedIVFIndex(
            dim=dim, mesh=mesh, n_clusters=n_clusters, nprobe=nprobe, **kw
        )
        self._doc_of: dict[str, str] = {}
        if self._path and os.path.exists(self._path + ".meta.json"):
            n = self.index.restore(self._path)
            logger.info("restored sharded-IVF collection %s (%d vectors)",
                        collection, n)

    def build(self, data: list[VectorData]) -> None:
        vecs = _normalize(np.stack([d.vector for d in data]))
        with self._lock:
            self.index.build(vecs, [d.id for d in data])
            for d in data:
                self._doc_of[d.id] = d.document_id
            self._calibrated = False

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        self._maybe_calibrate()
        out = super().search_batch(vectors, limit)
        # The index flags (never runs) maintenance: a tombstone-shortfall
        # query was answered by the bounded exact fallback and the table
        # wants a rebuild. Schedule it on the worker; in standalone mode
        # the next add/delete trigger (or an explicit rebuild()) covers it.
        if getattr(self.index, "maintenance_needed", False):
            if self.request_maintenance("search shortfall fallback"):
                self.index.maintenance_needed = False
        return out

    def _maybe_calibrate(self) -> None:
        if (self._prune_target is None and self._recall_target is None) \
                or self._calibrated:
            return
        with self._lock:
            if self._calibrated or self.index.data is None:
                return
            if self._recall_target is not None:
                pt = self.index.calibrate_operating_point(
                    target_recall=self._recall_target)
                self._calibrated = True
                logger.info("sharded ivf %s: operating point calibrated to "
                            "%s (recall target %.2f)",
                            self.collection, pt, self._recall_target)
                return
            m = self.index.calibrate_margin(
                target_overlap=self._prune_target,
                target_metric=self._prune_metric)
            self._calibrated = True
            logger.info(
                "sharded ivf %s: prune_margin calibrated to %s (target %.2f)",
                self.collection, m, self._prune_target)

    def _rebuild_locked(self) -> None:
        self.index.rebuild()
        self._maintenance_last = 0.0
        if self._prune_target is not None or self._recall_target is not None:
            self.index.prune_margin = None
            self._calibrated = False

    def rebuild(self) -> None:
        """Fold spill + drop tombstones + retrain (worker Maintain task
        entry point; never called from the query path)."""
        with self._lock:
            self._rebuild_locked()

    def add_vectors(self, data: list[VectorData]) -> None:
        super().add_vectors(data)
        if getattr(self, "_recovering", False):
            return
        spill = self.index.spill.count
        total = max(self.index.count, 1)
        if spill > 16384 or (total > 4096 and spill * 5 > total):
            with self._lock:
                folded = self.index.fold_spill()
            left = self.index.spill.count
            if left > 16384 or (total > 4096 and left * 5 > total):
                if not self.request_maintenance(
                        f"spill growth ({left}/{total})"):
                    logger.info(
                        "sharded ivf %s: auto-rebuild (folded=%d spill=%d total=%d)",
                        self.collection, folded, left, total)
                    with self._lock:
                        self._rebuild_locked()
            elif folded:
                logger.info("sharded ivf %s: folded %d spill rows in place",
                            self.collection, folded)

    def delete(self, ids: list[str]) -> int:
        n = super().delete(ids)
        # Same delete-churn bound as TpuIVFStore (tombstones persist until
        # rebuild and widen the over-fetch).
        if n and not getattr(self, "_recovering", False):
            dead = len(self.index._deleted)
            if dead > 256 and dead * 4 > max(self.index.count, 1):
                if not self.request_maintenance(
                        f"delete churn ({dead} tombstones)"):
                    logger.info(
                        "sharded ivf %s: delete-churn rebuild (%d tombstones)",
                        self.collection, dead)
                    with self._lock:
                        self._rebuild_locked()
        return n

    @property
    def count(self) -> int:
        return self.index.count

    def checkpoint(self) -> None:
        if self._path:
            with self._lock:
                self.index.save(self._path)


class MemoryStore:
    """Plain numpy store — hermetic test backend (no JAX dependency)."""

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384, **kw):
        self.collection = collection
        self.dim = dim
        self._vecs = np.zeros((0, dim), np.float32)
        self._ids: list[str] = []
        self._doc_of: dict[str, str] = {}

    @property
    def count(self) -> int:
        return len(self._ids)

    def add_vectors(self, data: list[VectorData]) -> None:
        if not data:
            return
        vecs = _normalize(np.stack([d.vector for d in data]))
        self._vecs = np.concatenate([self._vecs, vecs])
        self._ids.extend(d.id for d in data)
        for d in data:
            self._doc_of[d.id] = d.document_id

    def search(self, vector, limit: int):
        return self.search_batch(np.asarray(vector)[None, :], limit)[0]

    def search_batch(self, vectors, limit: int):
        vecs = _normalize(np.atleast_2d(vectors))
        out = []
        for q in vecs:
            if not self._ids:
                out.append([])
                continue
            scores = self._vecs @ q
            order = np.argsort(-scores)[:limit]
            out.append(
                [SearchHit(id=self._ids[i], score=float(scores[i]),
                           document_id=self._doc_of.get(self._ids[i])) for i in order]
            )
        return out

    def delete(self, ids: list[str]) -> int:
        keep = [i for i, sid in enumerate(self._ids) if sid not in set(ids)]
        removed = len(self._ids) - len(keep)
        self._vecs = self._vecs[keep]
        self._ids = [self._ids[i] for i in keep]
        for sid in ids:
            self._doc_of.pop(sid, None)
        return removed

    def delete_all(self) -> None:
        self._vecs = np.zeros((0, self.dim), np.float32)
        self._ids = []
        self._doc_of.clear()

    def checkpoint(self) -> None:
        pass
