"""Regression tests for the index/native/train review findings:

1. IVFIndex.rebuild() resurrection: after heavy deletes shrank the live
   set below the C*4 clustering floor, build()'s spill-only early return
   left the OLD cluster table installed while _deleted was cleared —
   every tombstoned row came back (reachable from the store's delete-churn
   auto-rebuild, i.e. exactly under heavy deletes).
2. Intra-batch duplicate ids created an undeletable ghost row (flat +
   sharded).
3. ShardedFlatIndex was fixed-capacity: an add past P*cap raised
   RuntimeError (killing a sharded-IVF build half-applied) instead of
   growing.
4. ShardedIVFIndex's kk<=512 over-fetch cap let concentrated deletes
   crowd out every live candidate with no fallback.
5. HNSW search filtered tombstones after a fixed-ef beam (deletes near
   the query returned < k while live neighbors existed), and load()
   accepted truncated/corrupt files unchecked.
6. train_encoder silently ran zero steps when the collection was smaller
   than the (device-rounded) batch size and exported unmodified weights.
"""

import numpy as np
import pytest

from memex_tpu.index import FlatIndex, IVFIndex, ShardedFlatIndex


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def rng():
    return np.random.default_rng(23)


@pytest.fixture
def mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]), ("shard",))


# -- 1: rebuild under heavy deletes must not resurrect ------------------------


def test_ivf_rebuild_below_cluster_floor_keeps_deletes(rng):
    d, n, C = 16, 2000, 64
    db = unit(rng, n, d)
    ids = [f"r{i}" for i in range(n)]
    idx = IVFIndex(dim=d, n_clusters=C, nprobe=C)
    idx.build(db, ids)
    assert idx.data is not None
    # Delete 1800 -> live 200 < C*4 = 256: the host rebuild path must
    # fully reset the table before build()'s spill-only early return.
    victims = [f"r{i}" for i in range(1800)]
    idx.delete(victims)
    idx.rebuild()
    assert idx.count == 200
    hits = {sid for h in idx.search(db[:8], 50) for sid, _ in h}
    assert not hits & set(victims), "tombstoned rows resurrected by rebuild"
    # And no duplicated live rows (spill + stale table copies).
    all_hits = idx.search(db[1900:1901], 200)[0]
    ids_seen = [sid for sid, _ in all_hits]
    assert len(ids_seen) == len(set(ids_seen))


def test_ivf_store_churn_rebuild_below_floor(rng, tmp_path):
    """The store's delete-churn trigger drives the same path end-to-end."""
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.tpu_store import TpuIVFStore

    d, n, C = 16, 1500, 64
    store = TpuIVFStore(str(tmp_path), "floor", dim=d, n_clusters=C,
                        nprobe=C)
    vecs = unit(rng, n, d)
    store.build([VectorData(id=f"c{i}", document_id="doc", text="",
                            vector=vecs[i], segment_id=i) for i in range(n)])
    store.delete([f"c{i}" for i in range(1300)])  # live 200 < C*4 = 256
    assert store.count == 200
    hits = store.search(vecs[5], 10)
    assert all(h.id != "c5" for h in hits)
    live_hit = store.search(vecs[1400], 1)[0]
    assert live_hit.id == "c1400"


# -- 2: intra-batch duplicate ids ---------------------------------------------


def test_flat_intra_batch_duplicate_is_deletable(rng):
    d = 16
    idx = FlatIndex(dim=d)
    v = unit(rng, 3, d)
    idx.add(np.stack([v[0], v[1], v[2]]), ["a", "a", "b"])
    assert idx.count == 2  # one live row per id
    assert idx.delete(["a"]) == 1
    hits = {sid for sid, _ in idx.search(v[:3], 3)[0]}
    assert "a" not in hits


def test_sharded_intra_batch_duplicate_is_deletable(rng, mesh):
    d = 16
    idx = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=64)
    v = unit(rng, 3, d)
    idx.add(np.stack([v[0], v[1], v[2]]), ["a", "a", "b"])
    assert idx.count == 2
    assert idx.delete(["a"]) == 1
    for hits in idx.search(v[:3], 3):
        assert all(sid != "a" for sid, _ in hits)


# -- 3: sharded capacity growth -------------------------------------------------


def test_sharded_index_grows_past_capacity(rng, mesh):
    d = 16
    idx = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=64,
                           dtype="int8")
    total_cap = idx.P * idx.cap
    n = total_cap + 200  # beyond the fixed capacity: raised before the fix
    db = unit(rng, n, d)
    idx.add(db[: total_cap // 2], [f"g{i}" for i in range(total_cap // 2)])
    idx.add(db[total_cap // 2 :],
            [f"g{i}" for i in range(total_cap // 2, n)])
    assert idx.count == n
    assert idx.P * idx.cap >= n
    hits = idx.search(db[n - 7 : n - 6], 1)[0]
    assert hits and hits[0][0] == f"g{n - 7}"


# -- 4: sharded IVF shortfall under concentrated deletes ------------------------


def test_sharded_ivf_concentrated_deletes_still_return_live(rng, mesh):
    from memex_tpu.index.sharded_ivf import ShardedIVFIndex

    d, n, C = 16, 4096, 4
    db = unit(rng, n, d)
    # One tight topic cluster around q: its top-600 rows all get deleted
    # (600 > the kk=512 over-fetch cap, < the 25% churn threshold).
    q = unit(rng, 1, d)
    db[:600] = q + 0.05 * rng.standard_normal((600, d)).astype(np.float32)
    db[:600] /= np.linalg.norm(db[:600], axis=1, keepdims=True)
    idx = ShardedIVFIndex(dim=d, mesh=mesh, n_clusters=C, nprobe=C)
    idx.build(db, [f"v{i}" for i in range(n)])
    idx.delete([f"v{i}" for i in range(600)])
    out = idx.search(q, 10)[0]
    assert len(out) == 10, f"shortfall: {len(out)} live hits"
    assert all(not (sid.startswith("v") and int(sid[1:]) < 600)
               for sid, _ in out)


# -- 5: hnsw tombstone widening + corrupt-file load ------------------------------


def test_hnsw_search_widens_past_tombstones(rng, tmp_path):
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.hnsw_store import HnswStore

    d, n = 32, 3000
    db = unit(rng, n, d)
    q = unit(rng, 1, d)[0]
    # Plant 64 near-duplicates of q, then delete them all: a fixed ef=32
    # beam would see only dead nodes and return nothing.
    db[:64] = q + 0.02 * rng.standard_normal((64, d)).astype(np.float32)
    db[:64] /= np.linalg.norm(db[:64], axis=1, keepdims=True)
    store = HnswStore(str(tmp_path), "w", dim=d)
    store.add_vectors(
        [VectorData(id=f"h{i}", document_id="d", text="", vector=db[i])
         for i in range(n)]
    )
    store.delete([f"h{i}" for i in range(64)])
    hits = store.search(q, 10)
    assert len(hits) == 10, f"only {len(hits)} live hits returned"
    assert all(int(h.id[1:]) >= 64 for h in hits)


def test_hnsw_load_rejects_truncated_file(rng, tmp_path):
    import ctypes
    import os

    from memex_tpu import native_lib
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.hnsw_store import HnswStore

    store = HnswStore(str(tmp_path), "c", dim=32)
    db = unit(rng, 200, 32)
    store.add_vectors(
        [VectorData(id=f"t{i}", document_id="d", text="", vector=db[i])
         for i in range(200)]
    )
    store.checkpoint()
    graph = next(p for p in os.listdir(tmp_path) if p.endswith(".hnsw.bin"))
    path = os.path.join(str(tmp_path), graph)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)  # crash mid-save
    lib = native_lib.hnsw_lib()
    lib.hnsw_load.restype = ctypes.c_void_p
    h = lib.hnsw_load(path.encode())
    assert not h, "corrupt checkpoint must load as nullptr, not garbage"


# -- 6: training on tiny collections ---------------------------------------------


def test_train_small_collection_runs_steps_or_raises(tmp_path):
    """A collection smaller than the rounded batch must either train with a
    reduced batch or raise — never silently export unmodified weights."""
    from test_encoder import tiny_engine

    from memex_tpu.config import Settings
    from memex_tpu.db import models, queue
    from memex_tpu.runtime import Runtime
    from memex_tpu.train.loop import train_encoder
    from memex_tpu.worker import tasks as executors

    settings = Settings.from_env(
        db_uri=f"sqlite://{tmp_path}/t.db", vector_uri="memory://",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    # 10 small docs -> >= n_dev pairs, so the reduced batch can still run.
    for i in range(10):
        queue.enqueue(rt.db, "tiny", f"document {i} alpha beta gamma",
                      queue.TaskType.Ingest)
        task = queue.check_for_jobs(rt.db, lease_s=300)
        executors.process_ingest(rt, task)

    out = train_encoder(rt, "tiny", epochs=1, batch_size=4096)
    assert out["step"] > 0, "zero training steps exported as fine-tuned"
