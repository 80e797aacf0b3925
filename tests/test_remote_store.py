"""Network-delegated vector backend: one memex_tpu node uses another as its
vector store over /api/vectors/* (the role OpenSearch plays for the
reference, storage/opensearch.rs:137-223 — but the remote here is a
device index node, not a JVM cluster)."""

import asyncio
import socket
import threading

import numpy as np
import pytest

from memex_tpu.config import Settings
from memex_tpu.runtime import Runtime
from memex_tpu.store.base import VectorData
from memex_tpu.store.remote import RemoteStore

from test_encoder import tiny_engine


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def remote_server(tmp_path):
    """A real memex_tpu API server (the 'index node') on an ephemeral port."""
    from memex_tpu.api.server import create_app

    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/remote.db",
        vector_uri="memory://",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    port = _free_port()
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def serve():
        from aiohttp import web

        runner = web.AppRunner(create_app(rt))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", port)
        await site.start()
        started.set()
        while not stop.is_set():
            await asyncio.sleep(0.05)
        await runner.cleanup()

    stop = threading.Event()
    thread = threading.Thread(target=lambda: loop.run_until_complete(serve()), daemon=True)
    thread.start()
    assert started.wait(timeout=30)
    yield f"http://127.0.0.1:{port}", rt
    stop.set()
    thread.join(timeout=10)


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_remote_store_roundtrip(remote_server):
    base, _ = remote_server
    rng = np.random.default_rng(5)
    d, n = 64, 50
    db = unit(rng, n, d)
    store = RemoteStore(base, "remcol", dim=d)
    store.add_vectors([
        VectorData(id=f"r{i}", document_id=f"doc{i%3}", text=f"t{i}",
                   vector=db[i], segment_id=i)
        for i in range(n)
    ])
    assert store.count == n
    hits = store.search(db[11], 3)
    assert hits[0].id == "r11" and hits[0].score > 0.99
    assert hits[0].document_id == "doc2"
    batch = store.search_batch(db[:4], 2)
    assert [h[0].id for h in batch] == ["r0", "r1", "r2", "r3"]
    assert store.delete(["r11"]) == 1
    assert store.search(db[11], 1)[0].id != "r11"
    store.delete_all()
    assert store.search_batch(db[:1], 1) == [[]]


def test_remote_scheme_via_registry(remote_server):
    base, _ = remote_server
    from memex_tpu.store.registry import _build_store

    uri = base.replace("http://", "memex+http://")
    store = _build_store(uri, "regcol", dim=64)
    assert isinstance(store, RemoteStore)
    rng = np.random.default_rng(6)
    db = unit(rng, 10, 64)
    store.add_vectors([
        VectorData(id=f"g{i}", document_id="d", text="", vector=db[i], segment_id=i)
        for i in range(10)
    ])
    assert store.search(db[4], 1)[0].id == "g4"
