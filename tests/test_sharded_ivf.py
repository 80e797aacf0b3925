"""ShardedIVFIndex tests on the virtual 8-device CPU mesh (SURVEY.md §4:
multi-device tests without hardware). The 100M-tier design: cluster shards
as experts, batch-union probe scan per shard, collective merge — replaces
the reference's OpenSearch delegation (storage/mod.rs:122-133)."""

import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from memex_tpu.index import FlatIndex, ShardedIVFIndex


def clustered(rng, n, d, centers=12, sigma=0.07):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, centers, n)] + sigma * rng.standard_normal(
        (n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


@pytest.fixture
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(jax.devices()[:8]), ("shard",))


def build_idx(rng, mesh, n=4096, d=32, C=16, nprobe=6, **kw):
    db = clustered(rng, n, d)
    idx = ShardedIVFIndex(dim=d, mesh=mesh, n_clusters=C, nprobe=nprobe, **kw)
    idx.build(db, [f"v{i}" for i in range(n)])
    return idx, db


class TestShardedIVF:
    def test_build_shards_and_searches(self, rng, mesh):
        idx, db = build_idx(rng, mesh)
        assert idx.C % 8 == 0 and idx.Cp == idx.C // 8
        # bucket table is actually sharded over the mesh axis
        shardings = {s.index for s in idx.data.addressable_shards}
        assert len(shardings) == 8
        qs = clustered(rng, 8, 32)
        hits = idx.search(qs, 10)
        assert all(len(h) == 10 for h in hits)
        exact = np.argsort(-(qs @ db.T), axis=1)[:, :10]
        got = sum(
            len({int(s[1:]) for s, _ in hits[q]} & set(exact[q].tolist()))
            for q in range(8)
        ) / 80.0
        assert got >= 0.7  # routed recall on clustered data

    def test_exhaustive_probe_matches_flat_int8(self, rng, mesh):
        """nprobe=C probes everything: results must match the int8 flat
        scan (same codes, same dot) — single-device-equivalence anchor."""
        n, d, k = 2048, 32, 10
        db = clustered(rng, n, d)
        idx = ShardedIVFIndex(dim=d, mesh=mesh, n_clusters=8, nprobe=8)
        idx.build(db, [f"v{i}" for i in range(n)])
        flat = FlatIndex(dim=d, dtype="int8")
        flat.add(db, [f"v{i}" for i in range(n)])
        qs = clustered(rng, 6, d)
        a, b = idx.search(qs, k), flat.search(qs, k)
        for ha, hb in zip(a, b):
            ids_a = {s for s, _ in ha}
            ids_b = {s for s, _ in hb}
            assert len(ids_a & ids_b) >= k - 1, (ids_a, ids_b)

    def test_spill_add_search_rebuild(self, rng, mesh):
        idx, db = build_idx(rng, mesh)
        extra = clustered(rng, 200, 32)
        idx.add(extra, [f"s{i}" for i in range(200)])
        assert idx.spill.count >= 200
        # nearest to an exact spill vector must surface through the merge
        hits = idx.search(extra[:2], 3)
        assert hits[0][0][0] == "s0" and hits[1][0][0] == "s1"
        idx.rebuild()
        assert idx.spill.count == 0 and idx.count == 4096 + 200
        hits = idx.search(extra[:2], 3)
        assert hits[0][0][0] == "s0"

    def test_delete_respected_across_rebuild(self, rng, mesh):
        idx, db = build_idx(rng, mesh, n=2048)
        idx.add(unit(rng, 100, 32), [f"s{i}" for i in range(100)])
        assert idx.delete(["v3", "s7"]) == 2
        hits = idx.search(db[3], 2048)
        assert "v3" not in {s for s, _ in hits[0]}
        idx.rebuild()
        assert idx.count == 2048 + 100 - 2
        hits = idx.search(db[3], 2048)
        seen = {s for s, _ in hits[0]}
        assert "v3" not in seen and "s7" not in seen
        assert None not in idx._live

    def test_save_restore_roundtrip(self, rng, mesh, tmp_path):
        idx, db = build_idx(rng, mesh)
        idx.add(clustered(rng, 64, 32), [f"s{i}" for i in range(64)])
        idx.delete(["v9"])
        path = str(tmp_path / "si")
        idx.save(path)
        qs = clustered(rng, 5, 32)
        before = idx.search(qs, 10)
        idx2 = ShardedIVFIndex(dim=32, mesh=mesh, n_clusters=16, nprobe=6)
        n = idx2.restore(path)
        assert n == idx.count == 4096 + 64 - 1
        after = idx2.search(qs, 10)
        for hb, ha in zip(before, after):
            assert {s for s, _ in hb} == {s for s, _ in ha}
        # centroids were NOT retrained on restore
        np.testing.assert_array_equal(np.asarray(idx.centroids),
                                      np.asarray(idx2.centroids))

    def test_incremental_checkpoint_base_immutable(self, rng, mesh, tmp_path):
        idx, _ = build_idx(rng, mesh, n=2048)
        path = str(tmp_path / "si")
        idx.save(path)
        base = open(path + ".npz", "rb").read()
        idx.add(clustered(rng, 30, 32), [f"s{i}" for i in range(30)])
        idx.save(path)
        assert open(path + ".npz", "rb").read() == base
        smeta = json.load(open(path + ".spill.meta.json"))
        seg = np.load(os.path.join(str(tmp_path), smeta["segments"][-1]))
        assert len(seg["ids"]) == 30

    def test_margin_prune_agrees_with_single_chip(self, rng, mesh):
        """The masked-union SPMD scan applies the same margin rule as the
        single-chip probe scan (ops/quant.prune_probes): with a margin
        that prunes, top-1 still agrees with the unpruned search."""
        n, d = 2048, 32
        db = clustered(rng, n, d)
        full = ShardedIVFIndex(dim=d, mesh=mesh, n_clusters=16, nprobe=6)
        full.build(db, [f"v{i}" for i in range(n)])
        pruned = ShardedIVFIndex(dim=d, mesh=mesh, n_clusters=16, nprobe=6,
                                 prune_margin=0.2)
        pruned.build(db, [f"v{i}" for i in range(n)])
        qs = clustered(rng, 4, d)
        a, b = full.search(qs, 8), pruned.search(qs, 8)
        for ha, hb in zip(a, b):
            ids_a = [s for s, _ in ha]
            ids_b = [s for s, _ in hb]
            assert ids_a[0] == ids_b[0]
            assert len(set(ids_a) & set(ids_b)) >= 6


class TestHundredMillionGeometry:
    def test_100m_shape_lowers_on_virtual_pod(self, mesh):
        """BASELINE config 5 geometry: 100M x 384 int8, C=16384 clusters,
        bucket M rounded to a 512 alignment — the SPMD search
        must trace and partition on an 8-way mesh (eval_shape: no buffers
        materialized). 38 GB of codes would not fit one chip; sharded it
        is ~4.8 GB/device on this virtual pod, ~0.6 GB/chip on 64 chips."""
        from memex_tpu.index.sharded_ivf import make_ivf_search_fn

        N, D, C = 100_000_000, 384, 16384
        M = -(-int(1.2 * N / C) // 512) * 512
        Cp = C // 8
        fn = make_ivf_search_fn(mesh, "shard", Cp, M, nprobe=64, kk=128)
        out = jax.eval_shape(
            fn,
            jax.ShapeDtypeStruct((C, D), np.float32),
            jax.ShapeDtypeStruct((C, M, D), np.int8),
            jax.ShapeDtypeStruct((C, M), np.float32),
            jax.ShapeDtypeStruct((C,), np.int32),
            jax.ShapeDtypeStruct((64, D), np.float32),
            jax.ShapeDtypeStruct((), np.float32),  # dynamic prune margin
        )
        assert out[0].shape == (64, 128) and out[1].shape == (64, 128)
        assert C * M >= N  # capacity actually covers the corpus


class TestMeshIVFStore:
    def test_store_roundtrip_via_registry(self, rng, mesh, tmp_path):
        from memex_tpu.store.base import VectorData
        from memex_tpu.store.registry import StoreRegistry

        reg = StoreRegistry()
        uri = f"tpu+ivf+mesh://{tmp_path}?n_clusters=8&nprobe=8"
        store = reg.get(uri, "col", dim=16)
        db = clustered(rng, 512, 16)
        store.build([
            VectorData(id=f"v{i}", document_id="d", text="", vector=db[i])
            for i in range(512)
        ])
        store.add_vectors([
            VectorData(id="extra", document_id="d2", text="",
                       vector=db[0] * 0.9 + 0.1)
        ])
        hits = store.search(db[0], 3)
        assert hits[0].id in ("v0", "extra")
        store.checkpoint()
        reg.drop(uri, "col")
        store2 = reg.get(uri, "col", dim=16)
        assert store2.count == 513
        hits2 = store2.search(db[0], 3)
        assert {h.id for h in hits2} == {h.id for h in hits}


class TestShardedFoldSpill:
    # bucket_factor=4.0: skewed clustered data must not saturate a bucket
    # at build time (which would overflow rows into the spill pre-test and
    # leave post-add folds partial — saturation behavior is covered by
    # test_fold_leaves_overflow_in_spill on the single-device tier).
    def test_fold_in_place(self, rng, mesh):
        idx, db = build_idx(rng, mesh, n=2048, C=8, nprobe=8,
                            bucket_factor=4.0)
        assert idx.spill.count == 0  # no build overflow
        extra = clustered(rng, 300, 32)
        idx.add(extra, [f"s{i}" for i in range(300)])
        cent = np.asarray(idx.centroids)
        folded = idx.fold_spill()
        assert folded == 300 and idx.spill.count == 0
        assert idx.count == 2048 + 300
        np.testing.assert_array_equal(np.asarray(idx.centroids), cent)
        hits = idx.search(extra[:4], 3)
        for i in range(4):
            assert hits[i][0][0] == f"s{i}", hits[i]

    def test_fold_keeps_checkpoint_zero_fetch(self, rng, mesh, tmp_path):
        idx, db = build_idx(rng, mesh, n=2048, C=8, nprobe=8,
                            bucket_factor=4.0)
        idx.add(clustered(rng, 100, 32), [f"s{i}" for i in range(100)])
        assert idx.fold_spill() == 100
        assert idx._host_codes is not None  # shadow extended, not dropped
        path = str(tmp_path / "fm")
        idx.save(path)
        qs = clustered(rng, 4, 32)
        idx2 = ShardedIVFIndex(dim=32, mesh=mesh, n_clusters=8, nprobe=8)
        assert idx2.restore(path) == idx.count
        a, b = idx.search(qs, 10), idx2.search(qs, 10)
        for ha, hb in zip(a, b):
            assert {s for s, _ in ha} == {s for s, _ in hb}

    def test_fold_respects_deletes(self, rng, mesh):
        idx, db = build_idx(rng, mesh, n=2048, C=8, nprobe=8,
                            bucket_factor=4.0)
        idx.add(clustered(rng, 60, 32), [f"s{i}" for i in range(60)])
        idx.delete(["s5"])
        assert idx.fold_spill() == 59
        assert idx.count == 2048 + 59
        hits = idx.search(clustered(rng, 2, 32), 2048)
        assert "s5" not in {s for hh in hits for s, _ in hh}


class TestShardedIVFRefine:
    """r4 verdict item 6: the 100M-tier path gets residual refinement —
    per-shard rerank at base+residual precision BEFORE the collective
    merge. Same near-tie construction as tests/test_refine.py: pairwise
    cos ~0.9995 puts informative gaps below int8 code resolution, so the
    plain tier MUST misrank and refine must restore the ranking."""

    def _neartie(self, rng, n=4096, d=64):
        mu = rng.standard_normal(d).astype(np.float32)
        mu /= np.linalg.norm(mu)
        v = mu[None, :] + 0.01 * rng.standard_normal((n, d)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        qs = v[rng.choice(n, 32, replace=False)]
        exact = np.argsort(-(qs @ v.T), axis=1)[:, :10]
        return v, qs, exact

    def _recall(self, hits, exact, k=10):
        return np.mean([
            len({int(s[1:]) for s, _ in hits[i][:k]}
                & set(exact[i].tolist())) / k
            for i in range(len(hits))
        ])

    def _build(self, mesh, v, refine):
        idx = ShardedIVFIndex(dim=v.shape[1], mesh=mesh, n_clusters=16,
                              nprobe=16, refine=refine)
        idx.build(v, [f"v{i}" for i in range(len(v))])
        return idx

    def test_refine_lifts_recall_over_plain_int8(self, rng, mesh):
        v, qs, exact = self._neartie(rng)
        plain = self._build(mesh, v, refine=False)
        refined = self._build(mesh, v, refine=True)
        assert refined.resid is not None and refined.rerank
        r_plain = self._recall(plain.search(qs, 10), exact)
        r_ref = self._recall(refined.search(qs, 10), exact)
        assert r_plain < 0.9, f"corpus not hard enough ({r_plain})"
        assert r_ref >= 0.97, (r_plain, r_ref)
        assert r_ref > r_plain + 0.1

    def test_refined_scores_are_near_exact(self, rng, mesh):
        v, qs, _ = self._neartie(rng)
        refined = self._build(mesh, v, refine=True)
        hits = refined.search(qs, 10)
        err = max(abs(score - float(qs[qi] @ v[int(sid[1:])]))
                  for qi in range(8) for sid, score in hits[qi])
        assert err < 2e-3, err  # plain int8 error is ~1e-2 here

    def test_refine_survives_save_load_and_rebuild(self, rng, mesh, tmp_path):
        v, qs, exact = self._neartie(rng)
        refined = self._build(mesh, v, refine=True)
        path = os.path.join(tmp_path, "ck")
        refined.save(path)
        fresh = ShardedIVFIndex(dim=v.shape[1], mesh=mesh, n_clusters=16,
                                nprobe=16, refine=True)
        assert fresh.restore(path) == len(v)
        assert fresh.resid is not None
        assert self._recall(fresh.search(qs, 10), exact) >= 0.97
        # residuals follow table rows through a rebuild (spill adds get
        # zero residuals until the next host build — never wrong, just
        # plain-int8 for those rows)
        fresh.add(v[:4] * 0.99 + 0.01, ["extra0", "extra1", "extra2", "extra3"])
        fresh.rebuild()
        assert fresh.resid is not None
        assert self._recall(fresh.search(qs, 10), exact) >= 0.95

    def test_store_uri_accepts_refine(self, mesh, tmp_path, monkeypatch):
        from memex_tpu.store.registry import _build_store

        store = _build_store(
            f"tpu+ivf+mesh://{tmp_path}/vec?refine=1&nprobe=16",
            "c_refine", dim=32)
        assert store.index.refine and store.index.rerank


class TestShardedCenteringCompat:
    def test_legacy_checkpoint_pins_zero_mean(self, rng, mesh, tmp_path):
        """A pre-centering checkpoint stores RAW codes and no mean; restore
        must pin mean=0 so later adds don't center new rows against a raw
        table (every merged score would shift by q.mean)."""
        import json as _json

        v = clustered(rng, 2048, 32)
        idx = ShardedIVFIndex(dim=32, mesh=mesh, n_clusters=8, nprobe=8, center=False)  # raw codes
        idx.build(v, [f"v{i}" for i in range(len(v))])
        assert not idx.mean.any()
        path = os.path.join(tmp_path, "legacy")
        idx.save(path)
        # simulate a pre-r5 meta: strip the mean key
        meta = _json.load(open(path + ".meta.json"))
        meta.pop("mean", None)
        _json.dump(meta, open(path + ".meta.json", "w"))

        back = ShardedIVFIndex(dim=32, mesh=mesh, n_clusters=8, nprobe=8)  # center defaults ON
        assert back.restore(path) == len(v)
        assert back.mean is not None and not back.mean.any()
        # adds stay in the raw code space; scores agree with true cosines
        back.add(v[:2] * 0.995 + 0.001, ["x0", "x1"])
        hits = back.search(v[:2], 3)
        for qi in range(2):
            for sid, score in hits[qi]:
                assert score <= 1.01, (sid, score)  # no q.mean inflation

    def test_centered_checkpoint_roundtrip_scores(self, rng, mesh, tmp_path):
        v = clustered(rng, 2048, 32)
        idx = ShardedIVFIndex(dim=32, mesh=mesh, n_clusters=8, nprobe=8)
        idx.build(v, [f"v{i}" for i in range(len(v))])
        assert idx.mean is not None
        path = os.path.join(tmp_path, "centered")
        idx.save(path)
        back = ShardedIVFIndex(dim=32, mesh=mesh, n_clusters=8, nprobe=8)
        assert back.restore(path) == len(v)
        np.testing.assert_allclose(back.mean, idx.mean)
        a = idx.search(v[:4], 5)
        b = back.search(v[:4], 5)
        for qi in range(4):
            assert [s for s, _ in a[qi]] == [s for s, _ in b[qi]]
            np.testing.assert_allclose([x for _, x in a[qi]],
                                       [x for _, x in b[qi]], atol=1e-5)
