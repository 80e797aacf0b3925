"""Microbatcher tests: correctness under concurrency, per-request limits."""

import threading

import numpy as np

from memex_tpu.config import Settings
from memex_tpu.runtime import Runtime
from memex_tpu.serve import Microbatcher
from memex_tpu.store.base import VectorData

from test_encoder import tiny_engine


def test_microbatcher_batches_and_returns_in_order():
    calls = []

    def run(items):
        calls.append(len(items))
        return [x * 2 for x in items]

    mb = Microbatcher(run, max_batch=16, max_wait_ms=20.0, name="t")
    results = [None] * 20
    threads = []

    def go(i):
        results[i] = mb(i)

    for i in range(20):
        t = threading.Thread(target=go, args=(i,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    mb.close()
    assert results == [i * 2 for i in range(20)]
    assert max(calls) > 1  # at least one real batch formed


def test_microbatcher_error_propagates():
    def run(items):
        raise ValueError("boom")

    mb = Microbatcher(run, max_batch=4, max_wait_ms=1.0, name="err")
    try:
        mb(1)
        assert False, "expected exception"
    except ValueError:
        pass
    finally:
        mb.close()


def test_search_batcher_end_to_end(tmp_path):
    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/b.db", vector_uri="memory://",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    store = rt.store("bcol")
    rng = np.random.default_rng(0)
    segs = [f"segment text {i}" for i in range(20)]
    vecs = rt.engine.encode_batch(segs)
    store.add_vectors(
        [VectorData(id=f"s{i}", document_id="d", text=segs[i], vector=vecs[i]) for i in range(20)]
    )
    out = [None, None, None]
    threads = [
        threading.Thread(target=lambda i=i: out.__setitem__(
            i, rt.search_batcher.search("bcol", segs[i * 5], 2 + i)))
        for i in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(3):
        assert len(out[i]) == 2 + i
        assert out[i][0].id == f"s{i*5}"  # self-query top-1


def test_fused_query_path_matches_two_step(tmp_path):
    """The one-dispatch encode+scan path must return the same hits as
    encode_batch -> store.search_batch."""
    import numpy as np

    from memex_tpu.serve.query_path import FusedQueryPath
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.tpu_store import TpuFlatStore

    from test_encoder import tiny_engine

    engine = tiny_engine()
    store = TpuFlatStore(str(tmp_path), "fusedcol", dim=engine.dim)
    corpus = [f"document number {i} about topic {i % 7}" for i in range(40)]
    vecs = engine.encode_batch(corpus)
    store.add_vectors([
        VectorData(id=f"c{i}", document_id="d", text=corpus[i], vector=vecs[i], segment_id=i)
        for i in range(len(corpus))
    ])

    fused = FusedQueryPath(engine)
    assert fused.supports(store)
    queries = ["document number 3", "topic 5 text", "something else entirely"]
    got = fused.search_texts(store, queries, 5)
    want = store.search_batch(engine.encode_batch(queries), 5)
    for g, w in zip(got, want):
        assert [sid for sid, _ in g] == [h.id for h in w]
        np.testing.assert_allclose(
            [v for _, v in g], [h.score for h in w], atol=2e-3
        )


def test_fused_query_path_int8_and_deletes(tmp_path):
    from memex_tpu.serve.query_path import FusedQueryPath
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.tpu_store import TpuFlatStore

    from test_encoder import tiny_engine

    engine = tiny_engine()
    store = TpuFlatStore(str(tmp_path), "fused8", dim=engine.dim, dtype="int8")
    corpus = [f"unique sentence {i} with words {i*3}" for i in range(30)]
    vecs = engine.encode_batch(corpus)
    store.add_vectors([
        VectorData(id=f"q{i}", document_id="d", text=corpus[i], vector=vecs[i], segment_id=i)
        for i in range(len(corpus))
    ])
    fused = FusedQueryPath(engine)
    top = fused.search_texts(store, [corpus[7]], 3)[0]
    assert top[0][0] == "q7"
    store.delete(["q7"])
    top = fused.search_texts(store, [corpus[7]], 3)[0]
    assert top and top[0][0] != "q7"


def test_search_batcher_warmup_compiles_bucket_lattice(tmp_path):
    """r5: warmup() must touch every (Q bucket <= max_batch) executable
    for a fused-path store — an unwarmed straggler bucket compiles inside
    a request.
    On a non-fused store it is a 0-executable no-op."""
    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/w.db",
        vector_uri=f"tpu://{tmp_path}/vec?dtype=float32&capacity=256",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    settings.search_max_batch = 100  # buckets to 128
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    store = rt.store("wcol")
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((32, 64)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    store.add_vectors(
        [VectorData(id=f"s{i}", document_id="d", text="t", vector=vecs[i])
         for i in range(32)]
    )
    # _Q_BUCKETS = (1, 8, 32, 64, 128, 256); max_batch=100 -> top bucket
    # 128 -> exactly 5 executables warmed for one seq bucket.
    n = rt.search_batcher.warmup("wcol")
    assert n == 5
    hits = rt.search_batcher.search("wcol", "query", 3)
    assert len(hits) == 3
    # empty store -> no fused path -> no-op
    rt.store("empty_col")
    assert rt.search_batcher.warmup("empty_col") == 0
    rt.search_batcher.close()


def test_fused_query_path_keeps_refine_rerank(tmp_path):
    """r5: a rerank/refine store must keep its exact-rerank quality
    through the serve path — the fused path used to drop the rerank for
    int8 stores (coarse-int8 rankings from an f32-fidelity store)."""
    import numpy as np

    from memex_tpu.serve.query_path import FusedQueryPath
    from memex_tpu.store.base import VectorData
    from test_encoder import tiny_engine

    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/r.db",
        vector_uri=f"tpu://{tmp_path}/vec?dtype=int8&refine=1&capacity=4096",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    store = rt.store("rcol")
    assert store.index.refine and store.index.rerank

    # near-tie corpus IN EMBEDDING SPACE: many texts whose tiny-encoder
    # vectors sit close — plain int8 misranks, the refine rerank fixes it
    texts = [f"common shared prefix words tail{i}" for i in range(512)]
    vecs = rt.engine.encode_batch(texts)
    store.add_vectors(
        [VectorData(id=f"s{i}", document_id="d", text=texts[i], vector=vecs[i])
         for i in range(len(texts))]
    )
    fused = FusedQueryPath(rt.engine)
    queries = [texts[7], texts[300]]
    got = fused.search_texts(store, queries, 5)
    want = store.search_batch(
        np.stack([vecs[7], vecs[300]]), 5)
    for qi in range(2):
        assert [sid for sid, _ in got[qi]] == [h.id for h in want[qi]], (
            got[qi], [(h.id, h.score) for h in want[qi]])
        np.testing.assert_allclose(
            [s for _, s in got[qi]], [h.score for h in want[qi]], atol=1e-4)
    rt.search_batcher.close()


def test_pipelined_batcher_bounds_inflight_and_propagates_finish_errors():
    """r5 pipeline mode: dispatches must stop at the semaphore depth when
    completions stall (backpressure, not unbounded queueing), and a
    finish() exception must land on that batch's futures only."""
    import time

    gate = threading.Event()
    dispatched = []

    def run_async(items):
        dispatched.append(list(items))

        def finish():
            gate.wait(10)
            if items[0] == "boom":
                raise ValueError("finish failed")
            return [x * 2 for x in items]

        return finish

    mb = Microbatcher(run_batch_async=run_async, max_batch=1,
                      max_wait_ms=1.0, name="pipe", pipeline_depth=3,
                      completer_threads=2)
    futs = [mb.submit(i) for i in range(8)]
    time.sleep(0.5)  # let the loop dispatch as far as backpressure allows
    # depth 3 in flight + up to completer_threads already pulled = bounded
    assert len(dispatched) <= 5, dispatched
    gate.set()
    assert [f.result(timeout=10) for f in futs] == [i * 2 for i in range(8)]

    gate.clear()
    bad = mb.submit("boom")
    ok = mb.submit(21)
    gate.set()
    try:
        bad.result(timeout=10)
        raise AssertionError("expected finish() error")
    except ValueError:
        pass
    assert ok.result(timeout=10) == 42  # later batch unaffected
    mb.close()


def test_direct_path_buckets_query_batch_and_warms_nonfused(tmp_path):
    """r5: non-fused stores (IVF/mesh) get bucketed query batches (index
    executables key on the padded Q shape — raw fill sizes would mint up
    to 16 multi-minute compiles per store) and warmup() covers them."""
    import numpy as np

    from memex_tpu.store.base import VectorData
    from test_encoder import tiny_engine

    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/ivf.db",
        vector_uri=f"tpu+ivf://{tmp_path}/vec?n_clusters=4&nprobe=4",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    settings.search_max_batch = 32
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    store = rt.store("icol")
    texts = [f"ivf doc {i} about topic {i % 7}" for i in range(64)]
    vecs = rt.engine.encode_batch(texts)
    store.add_vectors(
        [VectorData(id=f"s{i}", document_id="d", text=texts[i], vector=vecs[i])
         for i in range(64)]
    )
    seen_q: list[int] = []
    orig = store.search_batch

    def spy(vectors, limit):
        seen_q.append(len(vectors))
        return orig(vectors, limit)

    store.search_batch = spy
    # warmup covers the non-fused store: one call per reachable bucket
    assert rt.search_batcher.warmup("icol") == 3  # buckets (1, 8, 32)
    warm_qs = list(seen_q)
    assert warm_qs == [1, 8, 32], warm_qs
    seen_q.clear()
    # 3 concurrent requests -> one direct batch, bucketed to 8
    outs = [None] * 3
    threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, rt.search_batcher.search("icol", texts[i * 9], 3)))
        for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(len(o) == 3 for o in outs)
    assert all(q in (1, 8) for q in seen_q), seen_q  # bucketed, never raw 2/3
    assert outs[0][0].id == "s0"
    rt.search_batcher.close()
