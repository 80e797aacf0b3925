"""URI-scheme store factory + process-wide registry.

Reference: `get_vector_storage` parses the connection URI scheme and
builds a store per (uri, collection) (lib/libmemex/src/storage/mod.rs:95-139,
dim hardcoded 384 at :126). Here the registry caches live handles so the
index is constructed once per process — the reference rebuilds per call.
"""

from __future__ import annotations

import threading
from urllib.parse import parse_qsl, urlparse

from ..log import get_logger
from .base import VectorStore

logger = get_logger(__name__)

DEFAULT_DIM = 384  # MiniLM-L12 output (reference storage/mod.rs:126)


class StoreRegistry:
    def __init__(self):
        self._stores: dict[tuple[str, str], VectorStore] = {}
        self._lock = threading.Lock()

    def get(self, uri: str, collection: str, dim: int = DEFAULT_DIM) -> VectorStore:
        key = (uri, collection)
        with self._lock:
            store = self._stores.get(key)
            if store is None:
                store = _build_store(uri, collection, dim)
                self._stores[key] = store
            return store

    def drop(self, uri: str, collection: str) -> None:
        with self._lock:
            self._stores.pop((uri, collection), None)

    def checkpoint_all(self) -> None:
        with self._lock:
            stores = list(self._stores.values())
        for s in stores:
            s.checkpoint()


_REGISTRY = StoreRegistry()


def get_vector_storage(uri: str, collection: str, dim: int = DEFAULT_DIM) -> VectorStore:
    """Process-wide store lookup (live handle, not a fresh load)."""
    return _REGISTRY.get(uri, collection, dim)


_INT_OPTS = {"capacity", "n_clusters", "nprobe", "M", "ef_construction",
             "ef_search", "capacity_per_shard", "rerank"}
_BOOL_OPTS = {"query_quantize", "center", "refine"}
_FLOAT_OPTS = {"prune_margin", "prune_target", "recall_target", "bucket_factor"}
# Options that chose or tuned kernels which no longer exist. The scan
# implementation is chosen in one place (ops/scan_topk.use_kernel).
_REMOVED_OPTS = {
    "use_fused": "the scan implementation is chosen automatically",
    "scan_int4": "the int4 IVF scan kernel was removed",
    "block_n": "the kernel sizes its own blocks",
}


def _build_store(uri: str, collection: str, dim: int) -> VectorStore:
    """Scheme selects the backend; query params pass backend options, e.g.
    `tpu://./data?dtype=int8&capacity=65536` or `hnsw://./data?ef_search=64`
    (the reference's factory takes no options, storage/mod.rs:95-139)."""
    parsed = urlparse(uri)
    scheme = parsed.scheme or "tpu"
    path = (parsed.netloc + parsed.path) or "./vector_data"
    opts: dict = {}
    for key, val in parse_qsl(parsed.query):
        if key in _REMOVED_OPTS:
            raise ValueError(f"vector store option {key!r} was removed: "
                             f"{_REMOVED_OPTS[key]} (uri {uri!r}); see "
                             "docs/migration.md")
        if key in _INT_OPTS:
            opts[key] = int(val)
        elif key in _BOOL_OPTS:
            opts[key] = val.lower() not in ("0", "false", "no", "off")
        elif key in _FLOAT_OPTS:
            opts[key] = float(val)
        else:
            opts[key] = val
    if scheme == "tpu":
        from .tpu_store import TpuFlatStore

        return TpuFlatStore(path, collection, dim=dim, **opts)
    if scheme == "tpu+ivf":
        from .tpu_store import TpuIVFStore

        return TpuIVFStore(path, collection, dim=dim, **opts)
    if scheme == "tpu+mesh":
        from .tpu_store import TpuMeshStore

        return TpuMeshStore(path, collection, dim=dim, **opts)
    if scheme == "tpu+ivf+mesh":
        from .tpu_store import TpuMeshIVFStore

        return TpuMeshIVFStore(path, collection, dim=dim, **opts)
    if scheme == "memory":
        from .tpu_store import MemoryStore

        return MemoryStore(None, collection, dim=dim)
    if scheme == "hnsw":
        from .hnsw_store import HnswStore

        return HnswStore(path, collection, dim=dim, **opts)
    if scheme in ("memex+http", "memex+https"):
        from .remote import RemoteStore

        base = f"{scheme.split('+')[1]}://{path}"
        return RemoteStore(base, collection, dim=dim, **opts)
    raise ValueError(f"unsupported vector store scheme: {scheme!r} (uri {uri!r})")
