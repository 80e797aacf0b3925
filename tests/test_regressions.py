"""Regression tests for the round-1 advisor findings (ADVICE.md):

1. (high) first ingest into a collection duplicated every vector — the
   first-touch SQL rebuild raced the ingest's own add_vectors.
2. (medium) TpuMeshStore.checkpoint saved raw int8 codes without scales /
   raw bf16 that np.load cannot read back.
3. (medium) fused search crashed for limit > 128 (candidate bank width);
   the API passed 'limit' unvalidated.
4. (low) every ingest checkpointed the whole index (O(count) per doc).
5. (low) Runtime.store first-touch rebuild was check-then-act racy.
"""

import asyncio
import threading

import numpy as np
import pytest

from memex_tpu.config import Settings
from memex_tpu.db import queue
from memex_tpu.index import FlatIndex, ShardedFlatIndex
from memex_tpu.runtime import Runtime
from memex_tpu.worker import Worker

from test_encoder import tiny_engine


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def make_rt(tmp_path, name="reg"):
    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/{name}.db",
        vector_uri="memory://",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    return rt


# -- 1: ingest must not duplicate vectors ------------------------------------


def test_first_ingest_no_duplicates(tmp_path):
    rt = make_rt(tmp_path, "dup")
    worker = Worker(rt, poll_interval=0.01)
    queue.enqueue(rt.db, "dupcol", "one two three four five six", queue.TaskType.Ingest)
    assert worker.drain(timeout=60)

    store = rt.store("dupcol")
    n_sql = rt.db.query_one(
        "SELECT COUNT(*) AS n FROM embeddings WHERE collection = 'dupcol'"
    )["n"]
    assert store.count == n_sql  # was 2x before the fix

    q = rt.engine.encode_single("one two three")
    hits = store.search(q, 10)
    ids = [h.id for h in hits]
    assert len(ids) == len(set(ids)), f"duplicate hits: {ids}"


def test_flat_index_add_is_idempotent(rng):
    d, n = 32, 50
    db = unit(rng, n, d)
    ids = [f"i{i}" for i in range(n)]
    idx = FlatIndex(dim=d)
    idx.add(db, ids)
    idx.add(db, ids)  # re-add: e.g. rebuild raced an ingest
    assert idx.count == n
    res = idx.search(db[:3], 5)
    for qi, hits in enumerate(res):
        got = [sid for sid, _ in hits]
        assert got[0] == f"i{qi}"
        assert len(got) == len(set(got))


def test_sharded_index_add_is_idempotent(rng):
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:4]), ("shard",))
    d, n = 32, 40
    db = unit(rng, n, d)
    ids = [f"s{i}" for i in range(n)]
    idx = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=1024)
    idx.add(db, ids)
    idx.add(db[:20], ids[:20])
    assert idx.count == n
    hits = idx.search(db[:2], 3)
    for qi, row in enumerate(hits):
        assert row[0][0] == f"s{qi}"
        got = [sid for sid, _ in row]
        assert len(got) == len(set(got))


# -- 2: quantized mesh checkpoints round-trip ---------------------------------


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_mesh_checkpoint_quantized_roundtrip(tmp_path, rng, dtype):
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.tpu_store import TpuMeshStore

    d, n = 32, 64
    db = unit(rng, n, d)
    data = [
        VectorData(id=f"m{i}", document_id="doc", text=f"t{i}", vector=db[i], segment_id=i)
        for i in range(n)
    ]
    s1 = TpuMeshStore(str(tmp_path), f"mq-{dtype}", dim=d, dtype=dtype)
    s1.add_vectors(data)
    before = s1.search(db[5], 3)
    s1.checkpoint()

    s2 = TpuMeshStore(str(tmp_path), f"mq-{dtype}", dim=d, dtype=dtype)
    assert s2.count == n
    after = s2.search(db[5], 3)
    assert [h.id for h in after] == [h.id for h in before]
    # int8 without scales restored scores ~283x off; require close match.
    assert after[0].score == pytest.approx(before[0].score, abs=0.02)


# -- 3: wide limits ------------------------------------------------------------


def test_flat_search_k_over_128_falls_back(rng):
    d, n = 32, 300
    db = unit(rng, n, d)
    idx = FlatIndex(dim=d)
    idx._interpret = True  # the kernel serves k <= 128; wider goes to XLA
    idx.add(db, [f"w{i}" for i in range(n)])
    res = idx.search(db[:2], 200)
    assert len(res[0]) == 200
    assert res[0][0][0] == "w0"


def test_sharded_search_k_over_128_falls_back(rng):
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:2]), ("shard",))
    d, n = 32, 300
    db = unit(rng, n, d)
    idx = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=1024)
    idx._interpret = True  # the kernel serves k <= 128; wider goes to XLA
    idx.add(db, [f"w{i}" for i in range(n)])
    res = idx.search(db[:1], 150)
    assert len(res[0]) == 150
    assert res[0][0][0] == "w0"


def test_api_limit_validation(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    from memex_tpu.api.server import create_app

    rt = make_rt(tmp_path, "lim")

    async def drive():
        app = create_app(rt)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            for bad in ["abc", 0, -3, 101]:
                resp = await client.post(
                    "/api/collections/lims/search", json={"query": "x", "limit": bad}
                )
                assert resp.status == 400, (bad, resp.status)
            resp = await client.post(
                "/api/collections/lims/search", json={"query": "x", "limit": 5}
            )
            assert resp.status == 200
        finally:
            await client.close()

    asyncio.new_event_loop().run_until_complete(drive())


# -- 4/5: checkpoint cadence + rebuild race -----------------------------------


class _CountingStore:
    def __init__(self):
        self.checkpoints = 0

    def checkpoint(self):
        self.checkpoints += 1


def test_maybe_checkpoint_rate_limited(tmp_path):
    rt = make_rt(tmp_path, "ckpt")
    store = _CountingStore()
    assert rt.maybe_checkpoint("c", store, interval_s=3600)
    for _ in range(10):
        assert not rt.maybe_checkpoint("c", store, interval_s=3600)
    assert store.checkpoints == 1
    # interval 0 -> always checkpoints
    assert rt.maybe_checkpoint("c", store, interval_s=0.0)
    assert store.checkpoints == 2


def test_concurrent_first_touch_rebuilds_once(tmp_path):
    rt = make_rt(tmp_path, "race")
    worker = Worker(rt, poll_interval=0.01)
    queue.enqueue(rt.db, "racecol", "alpha beta gamma delta", queue.TaskType.Ingest)
    assert worker.drain(timeout=60)
    n = rt.store("racecol").count
    assert n > 0

    # Simulate restart: clear device state + rebuilt marker, then first-touch
    # from many threads at once. Exactly one rebuild must happen.
    rt.store("racecol").delete_all()
    rt._rebuilt.discard("racecol")
    barrier = threading.Barrier(8)
    errors = []

    def touch():
        try:
            barrier.wait(timeout=10)
            rt.store("racecol")
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=touch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    assert rt.store("racecol").count == n  # was n * <threads that raced> before
