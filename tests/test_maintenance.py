"""Maintenance lives on the worker, never on the query path.

Round-2 verdict item 5: a tombstone-shortfall query must return in O(one
search) with correct results while a rebuild is merely *scheduled*, and no
search call can invoke k-means. Covers the index-level exact fallback
(index/sharded_ivf.py), the store-level request_maintenance plumbing
(store/tpu_store.py), the runtime's queue wiring (runtime.py), and the
worker's Maintain executor (worker/tasks.py).
"""

import numpy as np
import pytest

from memex_tpu.config import Settings
from memex_tpu.db import queue
from memex_tpu.runtime import Runtime
from memex_tpu.store.base import VectorData
from memex_tpu.worker import Worker


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture
def mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("shard",))


def make_data(db, prefix="v"):
    return [
        VectorData(id=f"{prefix}{i}", document_id=f"d{i//10}", text=f"t{i}",
                   vector=db[i])
        for i in range(db.shape[0])
    ]


# -- 1: index level — shortfall search never retrains --------------------------


def test_shortfall_search_never_retrains(rng, mesh, monkeypatch):
    """Concentrated deletes past the kk=512 cap: the search must answer
    via the bounded exact fallback — rebuild()/k-means must NOT run."""
    from memex_tpu.index import sharded_ivf as siv

    d, n, C = 16, 4096, 4
    db = unit(rng, n, d)
    q = unit(rng, 1, d)
    db[:600] = q + 0.05 * rng.standard_normal((600, d)).astype(np.float32)
    db[:600] /= np.linalg.norm(db[:600], axis=1, keepdims=True)
    idx = siv.ShardedIVFIndex(dim=d, mesh=mesh, n_clusters=C, nprobe=C)
    idx.build(db, [f"v{i}" for i in range(n)])

    def _boom(*a, **kw):
        raise AssertionError("query path invoked a retrain")

    monkeypatch.setattr(idx, "rebuild", _boom)
    monkeypatch.setattr(siv, "kmeans_fit", _boom)
    idx.delete([f"v{i}" for i in range(600)])

    out = idx.search(q, 10)[0]
    assert len(out) == 10, f"shortfall not recovered: {len(out)} hits"
    assert all(int(sid[1:]) >= 600 for sid, _ in out)
    # Correctness of the fallback: matches the exact oracle on live rows.
    scores = db @ q[0]
    scores[:600] = -np.inf
    oracle = {f"v{i}" for i in np.argsort(-scores)[:10]}
    assert {sid for sid, _ in out} == oracle
    assert idx.maintenance_needed, "fallback must flag maintenance"


# -- 2: store level — shortfall schedules, does not rebuild inline -------------


def test_mesh_store_schedules_on_shortfall(rng, monkeypatch, tmp_path):
    from memex_tpu.store.tpu_store import TpuMeshIVFStore

    d, n = 16, 4096
    db = unit(rng, n, d)
    q = unit(rng, 1, d)
    db[:600] = q + 0.05 * rng.standard_normal((600, d)).astype(np.float32)
    db[:600] /= np.linalg.norm(db[:600], axis=1, keepdims=True)
    store = TpuMeshIVFStore(str(tmp_path), "sched", dim=d, n_clusters=4,
                            nprobe=4)
    store.build(make_data(db))

    scheduled = []
    store.on_maintenance = lambda col, reason: scheduled.append((col, reason))
    monkeypatch.setattr(
        store.index, "rebuild",
        lambda *a, **kw: (_ for _ in ()).throw(
            AssertionError("inline rebuild on the query path")))
    store.delete([f"v{i}" for i in range(600)])
    hits = store.search_batch(q, 10)[0]
    assert len(hits) == 10
    assert scheduled and scheduled[-1][0] == "sched"
    assert not store.index.maintenance_needed  # cleared once scheduled


def test_churn_trigger_schedules_not_inline(rng, monkeypatch, tmp_path):
    """The delete-churn threshold must route through request_maintenance
    when a scheduler is wired (worker owns the retrain)."""
    from memex_tpu.store.tpu_store import TpuIVFStore

    d, n = 16, 2048
    db = unit(rng, n, d)
    store = TpuIVFStore(str(tmp_path), "churn", dim=d, n_clusters=4, nprobe=4)
    store.build(make_data(db))
    scheduled = []
    store.on_maintenance = lambda col, reason: scheduled.append(reason)
    rebuilds = []
    monkeypatch.setattr(store.index, "rebuild",
                        lambda *a, **kw: rebuilds.append(1))
    store.delete([f"v{i}" for i in range(n // 2)])  # far past 25% churn
    assert scheduled, "churn should schedule maintenance"
    assert not rebuilds, "churn must not rebuild inline when wired"


def test_request_maintenance_dedup_window(tmp_path):
    from memex_tpu.store.tpu_store import TpuFlatStore

    store = TpuFlatStore(str(tmp_path), "dd", dim=8)
    calls = []
    store.on_maintenance = lambda col, reason: calls.append(reason)
    assert store.request_maintenance("a")
    assert store.request_maintenance("b")  # inside the window: suppressed
    assert calls == ["a"]
    store._maintenance_last = 0.0
    assert store.request_maintenance("c")
    assert calls == ["a", "c"]


def test_request_maintenance_unwired_returns_false(tmp_path):
    from memex_tpu.store.tpu_store import TpuFlatStore

    store = TpuFlatStore(str(tmp_path), "uw", dim=8)
    assert store.request_maintenance("x") is False


# -- 3: runtime + worker — the Maintain task lands the rebuild -----------------


def make_rt(tmp_path, vector_uri):
    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/m.db",
        vector_uri=vector_uri,
        embedding_model="random",
    )
    settings.embedding_dim = 16
    return Runtime(settings)


def test_maintain_task_end_to_end(rng, tmp_path):
    """Enqueue Maintain -> worker claims it -> store rebuild folds the
    spill (the full scheduled-maintenance loop)."""
    rt = make_rt(tmp_path, f"tpu+ivf://{tmp_path}/vec?n_clusters=4&nprobe=4")
    store = rt.store("mcol")
    assert store.on_maintenance is not None  # runtime wired the scheduler
    d = 16
    db = unit(rng, 512, d)
    store.build(make_data(db))
    store.add_vectors(make_data(unit(rng, 64, d), prefix="s"))
    assert store.index.spill.count > 0

    queue.enqueue(rt.db, "mcol", "test", queue.TaskType.Maintain)
    worker = Worker(rt, poll_interval=0.005)
    assert worker.drain(timeout=60)
    row = rt.db.query_one(
        "SELECT status, task_output FROM queue WHERE task_type='Maintain'")
    assert row["status"] == "Completed"
    assert store.index.spill.count == 0, "Maintain task did not fold spill"


def test_runtime_enqueue_dedup(tmp_path):
    rt = make_rt(tmp_path, "memory://")
    rt._enqueue_maintenance("c1", "first")
    rt._enqueue_maintenance("c1", "second")  # pending -> deduped
    row = rt.db.query_one(
        "SELECT COUNT(*) AS n FROM queue WHERE task_type='Maintain'")
    assert row["n"] == 1
    assert queue.has_pending(rt.db, "c1", queue.TaskType.Maintain)
    assert not queue.has_pending(rt.db, "c2", queue.TaskType.Maintain)


def test_maintain_on_plain_store_is_noop(tmp_path):
    """Stores without a rebuild surface complete the task gracefully."""
    rt = make_rt(tmp_path, "memory://")
    queue.enqueue(rt.db, "plain", "x", queue.TaskType.Maintain)
    worker = Worker(rt, poll_interval=0.005)
    assert worker.drain(timeout=30)
    row = rt.db.query_one("SELECT status FROM queue WHERE task_type='Maintain'")
    assert row["status"] == "Completed"
