"""Regression tests for the round-2 control-plane review findings:

1. Ingest retry idempotency — the deterministic document uuid (uuid5 of
   the task id) hit documents.uuid UNIQUE on every re-run, converting a
   retryable failure into a permanently Failed task; embeddings rows also
   duplicated per retry.
2. A best-effort checkpoint failure must not fail an already-durable
   ingest.
3. process_extract crashed on valid non-object JSON content.
4. Runtime.store marked a collection rebuilt BEFORE recovery with no
   rollback, so a failed rebuild was never retried (silently empty
   results for the process lifetime).
5. A task claimed while shutdown() closed the pool killed the scheduler
   thread and parked the task in Processing for its whole lease.
6. encode_single/search_texts crashed for max_seq_length values that are
   not themselves seq buckets (e.g. 384).
7. fused_score_topk_int8q_rerank ignored the alive mask in its coarse
   scan (tombstones could shadow live candidates).
"""

import numpy as np
import pytest

from memex_tpu.config import Settings
from memex_tpu.db import models, queue
from memex_tpu.runtime import Runtime
from memex_tpu.worker import Worker
from memex_tpu.worker import tasks as executors

from test_encoder import tiny_engine


def make_rt(tmp_path, name="rob"):
    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/{name}.db",
        vector_uri="memory://",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    return rt


def _claim(rt):
    task = queue.check_for_jobs(rt.db, lease_s=300)
    assert task is not None
    return task


# -- 1: retrying a half-done ingest must succeed ------------------------------


def test_ingest_retry_is_idempotent(tmp_path):
    rt = make_rt(tmp_path, "retry")
    queue.enqueue(rt.db, "rcol", "alpha beta gamma delta", queue.TaskType.Ingest)
    task = _claim(rt)

    # First attempt: dies AFTER the SQL inserts (simulated store failure).
    orig_add = Runtime.add_vectors
    calls = {"n": 0}

    def flaky_add(self, collection, items):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated device hiccup")
        return orig_add(self, collection, items)

    Runtime.add_vectors = flaky_add
    try:
        with pytest.raises(RuntimeError):
            executors.process_ingest(rt, task)
        # Retry (as the scheduler would): must not trip documents.uuid
        # UNIQUE and must not duplicate embeddings rows.
        executors.process_ingest(rt, task)
    finally:
        Runtime.add_vectors = orig_add

    n_docs = rt.db.query_one("SELECT COUNT(*) AS n FROM documents")["n"]
    assert n_docs == 1
    doc_uuid = models.document_uuid_for_task(task.id)
    n_emb = rt.db.query_one(
        "SELECT COUNT(*) AS n FROM embeddings WHERE document_id=?", (doc_uuid,)
    )["n"]
    n_distinct = rt.db.query_one(
        "SELECT COUNT(DISTINCT uuid) AS n FROM embeddings WHERE document_id=?",
        (doc_uuid,),
    )["n"]
    assert n_emb == n_distinct > 0  # no duplicated segment rows
    assert rt.store("rcol").count == n_emb


# -- 2: checkpoint failure is not an ingest failure ---------------------------


def test_checkpoint_failure_does_not_fail_ingest(tmp_path, monkeypatch):
    rt = make_rt(tmp_path, "ckptfail")
    queue.enqueue(rt.db, "ccol", "one two three", queue.TaskType.Ingest)
    task = _claim(rt)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(Runtime, "maybe_checkpoint", boom)
    executors.process_ingest(rt, task)  # must not raise
    assert rt.store("ccol").count > 0


# -- 3: extract with non-object JSON content ----------------------------------


@pytest.mark.parametrize("content", ["2024", '"just a string"', "[1, 2, 3]"])
def test_extract_non_object_json_is_plain_text(tmp_path, content):
    rt = make_rt(tmp_path, "extract")
    queue.enqueue(rt.db, "e", content, queue.TaskType.Extract)
    task = _claim(rt)
    out = executors.process_extract(rt, task)
    assert isinstance(out, dict) and ("jsonResponse" in out or "response" in out)


# -- 4: failed first-touch recovery is retried --------------------------------


def test_failed_recovery_is_retried_on_next_touch(tmp_path, monkeypatch):
    rt = make_rt(tmp_path, "recov")
    # Seed SQL with one embedding so first touch wants a rebuild.
    queue.enqueue(rt.db, "rc", "seed text for recovery", queue.TaskType.Ingest)
    task = _claim(rt)
    executors.process_ingest(rt, task)
    # New runtime = fresh process: a DIFFERENT vector uri gives an empty
    # store (the registry caches per (uri, collection)), same SQL file.
    rt2 = make_rt(tmp_path, "recov")
    rt2.settings.vector_uri = "memory://fresh-process"
    rt2._db = rt.db

    calls = {"n": 0}

    from memex_tpu import recovery

    orig = recovery.rebuild_collection

    def flaky(rt_, col, batch=4096, force=False):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient rebuild failure")
        return orig(rt_, col, batch=batch, force=force)

    monkeypatch.setattr(recovery, "rebuild_collection", flaky)
    with pytest.raises(RuntimeError):
        rt2.store("rc")
    assert "rc" not in rt2._rebuilt  # mark rolled back
    store = rt2.store("rc")  # retried and succeeded
    assert calls["n"] == 2
    assert store.count > 0


# -- 5: claim/shutdown race requeues instead of killing the scheduler ---------


def test_claim_after_pool_shutdown_requeues(tmp_path):
    rt = make_rt(tmp_path, "race")
    worker = Worker(rt, poll_interval=0.01)
    worker._pool.shutdown(wait=True)  # simulate shutdown() winning the race
    queue.enqueue(rt.db, "x", "content", queue.TaskType.Ingest)
    claimed = worker.poll_once()  # must not raise
    assert claimed is False
    assert worker._active == 0
    row = rt.db.query_one("SELECT status, num_retries FROM queue")
    assert row["status"] == "Queued"  # back in the queue...
    assert row["num_retries"] == 0    # ...without burning a retry


# -- 6: non-bucket max_seq_length ----------------------------------------------


def test_encode_single_non_bucket_max_seq_length():
    eng = tiny_engine()
    eng.max_seq_length = 48  # not in _SEQ_BUCKETS (32, 64, ...)
    long_query = " ".join(f"tok{i}" for i in range(120))
    vec = eng.encode_single(long_query)  # crashed before the fix
    assert vec.shape == (eng.dim,)


# -- 7: int8q rerank respects tombstones in the coarse scan --------------------


def test_int8q_rerank_alive_mask_in_coarse_scan(rng=None):
    import jax.numpy as jnp

    from memex_tpu.index.flat import device_search
    from memex_tpu.ops.quant import quantize_rows_int8

    rng = np.random.default_rng(5)
    d, n = 128, 2048
    db = rng.standard_normal((n, d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[:4] + 0.01 * rng.standard_normal((4, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db8, s8 = quantize_rows_int8(jnp.asarray(db))
    # Tombstone the true top rows: with alive ignored in the coarse scan
    # they crowd the candidates; with in-kernel masking the top-k is
    # all-live.
    alive = np.ones((n,), np.float32)
    alive[:4] = 0.0
    vals, idx = device_search(
        db8, s8, jnp.asarray(alive), n, jnp.asarray(q), None, None,
        k=8, k_ret=64, kernel=True, mode="int8q", interpret=True)
    idx = np.asarray(idx)
    vals = np.asarray(vals)
    live = vals > -1e29
    assert live.all(), "candidates crowded by tombstones left < k live hits"
    assert not np.isin(idx[live], np.arange(4)).any()


# -- 8: microbatcher actually fills batches ------------------------------------


def test_microbatcher_fills_batches_under_backlog():
    import threading

    from memex_tpu.serve.batcher import Microbatcher

    release = threading.Event()
    sizes = []

    def run(items):
        sizes.append(len(items))
        if len(sizes) == 1:
            release.wait(10)  # hold the first batch while a backlog forms
        return items

    mb = Microbatcher(run, max_batch=8, max_wait_ms=30.0, name="t")
    futs = [mb.submit(0)]  # first batch (size 1) blocks in run()
    import time

    time.sleep(0.05)
    futs += [mb.submit(i) for i in range(1, 9)]  # 8-item backlog
    release.set()
    for f in futs:
        f.result(timeout=10)
    mb.close()
    # The backlog batch must be collected as ONE full batch, not the ~2-item
    # dribble the single-notify wait produced.
    assert sizes[0] == 1 and max(sizes[1:]) == 8, sizes


# -- 9: fused query path chunks oversized microbatches --------------------------


def test_fused_query_path_chunks_past_terminal_bucket(tmp_path):
    from memex_tpu.serve.query_path import FusedQueryPath, _Q_BUCKETS
    from memex_tpu.store.tpu_store import TpuFlatStore

    eng = tiny_engine()
    store = TpuFlatStore(None, "big", dim=eng.dim)
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((64, eng.dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    from memex_tpu.store.base import VectorData

    store.add_vectors([
        VectorData(id=f"d{i}", document_id="doc", text="", vector=vecs[i],
                   segment_id=i) for i in range(64)
    ])
    fq = FusedQueryPath(eng)
    n = _Q_BUCKETS[-1] + 44  # over the terminal query bucket
    out = fq.search_texts(store, [f"query {i}" for i in range(n)], 3)
    assert len(out) == n
    assert all(len(hits) == 3 for hits in out)


# -- 10: interrupted recovery leaves no partial store ---------------------------


def test_interrupted_rebuild_cleans_up_and_retries(tmp_path):
    from memex_tpu import recovery

    rt = make_rt(tmp_path, "partial")
    for i in range(6):
        queue.enqueue(rt.db, "pc", f"document number {i} with words",
                      queue.TaskType.Ingest)
        executors.process_ingest(rt, _claim(rt))
    n_sql = rt.db.query_one(
        "SELECT COUNT(*) AS n FROM embeddings WHERE collection='pc'")["n"]
    assert n_sql >= 6

    # Fresh-process store (empty), same SQL. rt2.store is stubbed to the
    # raw store so the runtime's own first-touch auto-rebuild does not
    # preempt the direct rebuild_collection call under test.
    rt2 = make_rt(tmp_path, "partial")
    rt2.settings.vector_uri = "memory://partial2"
    rt2._db = rt.db
    from memex_tpu.store import get_vector_storage

    store = get_vector_storage("memory://partial2", "pc",
                               dim=rt2.settings.embedding_dim)
    rt2.store = lambda c: store

    calls = {"n": 0}
    orig = type(store).add_vectors

    def flaky(self, data):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device lost mid-stream")
        return orig(self, data)

    type(store).add_vectors = flaky
    try:
        with pytest.raises(RuntimeError):
            recovery.rebuild_collection(rt2, "pc", batch=2)
        # The partial restore was rolled back: a later retry is NOT gated
        # out by count>0 and restores everything.
        assert store.count == 0, "partial rebuild left rows behind"
        restored = recovery.rebuild_collection(rt2, "pc", batch=2)
    finally:
        type(store).add_vectors = orig
    assert restored == n_sql
    assert store.count == n_sql
