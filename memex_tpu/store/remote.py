"""RemoteStore — delegate vector storage to another memex_tpu service.

The reference's scale-out story is delegation to an external OpenSearch
cluster (lib/libmemex/src/storage/opensearch.rs:137-223, factory
storage/mod.rs:122-133). Here the external service is another memex_tpu
node (e.g. a dedicated GPU index host serving many API front-ends), spoken
to over its /api/vectors/* routes.

URI scheme: `memex+http://host:port` or `memex+https://host` (query params
forwarded as store options on the REMOTE side are not supported — the
remote's own VECTOR_CONNECTION decides its tier).
"""

from __future__ import annotations

import numpy as np

from ..log import get_logger
from .base import SearchHit, VectorData

logger = get_logger(__name__)


class RemoteStore:
    def __init__(self, base_url: str, collection: str, dim: int = 384,
                 timeout: float = 120.0, **kw):
        import requests

        self._requests = requests
        self.base_url = base_url.rstrip("/")
        self.collection = collection
        self.dim = dim
        self.timeout = float(timeout)  # may arrive as a URI query string
        self._count: int | None = None

    def _url(self, suffix: str = "") -> str:
        return f"{self.base_url}/api/vectors/{self.collection}{suffix}"

    def _post(self, suffix: str, payload: dict) -> dict:
        resp = self._requests.post(self._url(suffix), json=payload, timeout=self.timeout)
        resp.raise_for_status()
        body = resp.json()
        if body.get("status") != "ok":
            raise RuntimeError(f"remote store error: {body!r}")
        return body["result"]

    @property
    def count(self) -> int:
        if self._count is None:
            try:
                stats = self._requests.get(
                    f"{self.base_url}/api/stats", timeout=self.timeout
                ).json()
                self._count = int(stats.get("collections", {}).get(self.collection, 0))
            except Exception:
                self._count = 0
        return self._count

    def add_vectors(self, data: list[VectorData]) -> None:
        if not data:
            return
        result = self._post("", {
            "items": [
                {
                    "id": d.id,
                    "documentId": d.document_id,
                    "text": d.text,
                    "vector": np.asarray(d.vector, np.float32).tolist(),
                    "segmentId": d.segment_id,
                }
                for d in data
            ]
        })
        self._count = int(result.get("count", 0))

    def search(self, vector: np.ndarray, limit: int) -> list[SearchHit]:
        return self.search_batch(np.asarray(vector)[None, :], limit)[0]

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        vecs = np.atleast_2d(np.asarray(vectors, np.float32))
        result = self._post("/search", {"vectors": vecs.tolist(), "limit": limit})
        return [
            [SearchHit(id=h["id"], score=h["score"], document_id=h.get("documentId"))
             for h in hits]
            for hits in result["results"]
        ]

    def delete(self, ids: list[str]) -> int:
        result = self._post("/delete", {"ids": list(ids)})
        self._count = None
        return int(result.get("removed", 0))

    def delete_all(self) -> None:
        self._post("/delete", {})
        self._count = 0

    def checkpoint(self) -> None:
        pass  # durability is the remote node's concern
