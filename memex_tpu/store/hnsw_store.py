"""HNSW store — native C++ graph index behind the `hnsw://` URI scheme.

Role parity with the reference's file-based HNSW store
(lib/libmemex/src/storage/local.rs): same default build parameters
(M=16, ef_construction=200, ef_search=32 — local.rs:101,76), same
id-mapping responsibility, cosine similarity output. Used as the CPU
baseline the device flat/IVF tiers are benchmarked against (BASELINE.md).

Unlike the reference, the graph is NOT re-saved per insert nor re-loaded
per query; `checkpoint()` persists on demand.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading

import numpy as np

from ..native_lib import hnsw_lib
from .base import SearchHit, VectorData

DEFAULT_M = 16
DEFAULT_EF_CONSTRUCTION = 200
DEFAULT_EF_SEARCH = 32


def _normalize(vectors: np.ndarray) -> np.ndarray:
    vectors = np.ascontiguousarray(vectors, np.float32)
    norms = np.linalg.norm(vectors, axis=-1, keepdims=True)
    return vectors / np.maximum(norms, 1e-12)


class HnswStore:
    def __init__(
        self,
        base_dir: str | None,
        collection: str,
        dim: int = 384,
        M: int = DEFAULT_M,
        ef_construction: int = DEFAULT_EF_CONSTRUCTION,
        ef_search: int = DEFAULT_EF_SEARCH,
    ):
        self.lib = hnsw_lib()
        self.collection = collection
        self.dim = dim
        self.ef_search = ef_search
        self._lock = threading.Lock()
        self._path = None
        self._ids: list[str] = []          # native id (row) -> string id
        self._row_of: dict[str, int] = {}
        self._doc_of: dict[str, str] = {}
        self._h = None
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.hnsw")
        if self._path and os.path.exists(self._path + ".bin"):
            self._h = self.lib.hnsw_load(self._path.encode() + b".bin")
            with open(self._path + ".meta.json", "r", encoding="utf-8") as fh:
                meta = json.load(fh)
            self._ids = meta["ids"]
            self._doc_of = meta.get("docs", {})
            self._row_of = {sid: i for i, sid in enumerate(self._ids) if sid is not None}
            self.dim = meta["dim"]
        else:
            self._h = self.lib.hnsw_new(dim, M, ef_construction)

    def __del__(self):
        try:
            if self._h:
                self.lib.hnsw_free(self._h)
        except Exception:
            pass

    @property
    def count(self) -> int:
        return len(self._row_of)

    def add_vectors(self, data: list[VectorData]) -> None:
        if not data:
            return
        vecs = _normalize(np.stack([d.vector for d in data]))
        n = len(data)
        out_rows = (ctypes.c_uint32 * n)()
        with self._lock:
            self.lib.hnsw_add_batch(
                self._h,
                vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n,
                out_rows,
            )
            for i, d in enumerate(data):
                row = int(out_rows[i])
                while len(self._ids) <= row:
                    self._ids.append(None)
                self._ids[row] = d.id
                self._row_of[d.id] = row
                self._doc_of[d.id] = d.document_id

    def search(self, vector: np.ndarray, limit: int) -> list[SearchHit]:
        return self.search_batch(np.asarray(vector)[None, :], limit)[0]

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        vecs = _normalize(np.atleast_2d(vectors))
        out = []
        ids_buf = (ctypes.c_uint32 * limit)()
        scores_buf = (ctypes.c_float * limit)()
        with self._lock:
            for q in vecs:
                n = self.lib.hnsw_search(
                    self._h,
                    q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    limit,
                    max(self.ef_search, limit),
                    ids_buf,
                    scores_buf,
                )
                hits = []
                for i in range(n):
                    sid = self._ids[ids_buf[i]]
                    if sid is None:
                        continue
                    hits.append(
                        SearchHit(id=sid, score=float(scores_buf[i]),
                                  document_id=self._doc_of.get(sid))
                    )
                out.append(hits)
        return out

    def delete(self, ids: list[str]) -> int:
        removed = 0
        with self._lock:
            for sid in ids:
                row = self._row_of.pop(sid, None)
                if row is not None:
                    self.lib.hnsw_mark_deleted(self._h, row)
                    self._ids[row] = None
                    self._doc_of.pop(sid, None)
                    removed += 1
        return removed

    def delete_all(self) -> None:
        with self._lock:
            self.lib.hnsw_free(self._h)
            self._h = self.lib.hnsw_new(self.dim, DEFAULT_M, DEFAULT_EF_CONSTRUCTION)
            self._ids = []
            self._row_of = {}
            self._doc_of = {}
            if self._path:
                for suffix in (".bin", ".meta.json"):
                    try:
                        os.remove(self._path + suffix)
                    except FileNotFoundError:
                        pass

    def checkpoint(self) -> None:
        if not self._path:
            return
        with self._lock:
            rc = self.lib.hnsw_save(self._h, self._path.encode() + b".bin")
            if rc != 0:
                raise IOError(f"hnsw_save failed: {self._path}")
            with open(self._path + ".meta.json", "w", encoding="utf-8") as fh:
                json.dump({"dim": self.dim, "ids": self._ids, "docs": self._doc_of}, fh)
