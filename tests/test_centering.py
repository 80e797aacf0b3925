"""Anisotropy-corrected int8 quantization (FlatIndex/IVFIndex `center`).

Real sentence embeddings concentrate around a large common mean (pairwise
cos 0.95+ on both random- and pretrained-MiniLM corpora), so raw int8
quantization burns the code range on the shared component — the round-2
sotu bench recorded int8-vs-f32 recall 0.84 for exactly this reason.
Storing quantize(v - mean) spends the range on the informative residual;
ranking is preserved (q.v = q.mean + q.delta with q.mean query-constant)
and true cosines are restored host-side after the device top-k, so no
compiled kernel changes. These tests pin: the recall win on concentrated
corpora, true-score restoration, cross-component consistency (spill/fold/
rebuild share one code space), persistence, and the raw semantics of
device-built (caller-quantized) corpora.
"""

import numpy as np
import pytest

from memex_tpu.index import FlatIndex, IVFIndex


@pytest.fixture
def concentrated(scope="module"):
    """Unit corpus at pairwise cos ~0.99 (the anisotropic regime)."""
    rng = np.random.default_rng(7)
    d, n = 64, 4096
    mu = rng.standard_normal(d).astype(np.float32)
    mu /= np.linalg.norm(mu)
    v = mu[None, :] + 0.03 * rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    qs = v[rng.choice(n, 32, replace=False)]
    return v, qs


def _recall(hits, exact, k=10):
    return np.mean([
        len({int(s[1:]) for s, _ in hits[i][:k]} & set(exact[i].tolist())) / k
        for i in range(len(hits))
    ])


def test_centered_int8_beats_raw_on_concentrated(concentrated):
    db, qs = concentrated
    exact = np.argsort(-(qs @ db.T), axis=1)[:, :10]
    ids = [f"r{i}" for i in range(len(db))]

    raw = FlatIndex(dim=64, dtype="int8", center=False)
    raw.add(db, ids)
    cen = FlatIndex(dim=64, dtype="int8")  # center defaults ON for int8
    cen.add(db, ids)
    assert cen.mean is not None and cen.mean.any()

    r_raw = _recall(raw.search(qs, 10), exact)
    r_cen = _recall(cen.search(qs, 10), exact)
    # Measured at this geometry: raw 0.884, centered 0.953 (the gap grows
    # as concentration rises: raw 0.753 vs centered 0.947 at noise 0.02).
    assert r_cen >= 0.95, (r_raw, r_cen)
    assert r_cen > r_raw + 0.05, (r_raw, r_cen)


def test_centered_scores_are_true_cosines(concentrated):
    db, qs = concentrated
    idx = FlatIndex(dim=64, dtype="int8")
    idx.add(db, [f"r{i}" for i in range(len(db))])
    hits = idx.search(qs[:4], 5)
    for qi in range(4):
        for sid, score in hits[qi]:
            true = float(qs[qi] @ db[int(sid[1:])])
            assert abs(score - true) < 5e-3, (sid, score, true)


def test_centered_int4_tier(concentrated):
    db, qs = concentrated
    exact = np.argsort(-(qs @ db.T), axis=1)[:, :10]
    idx = FlatIndex(dim=64, dtype="int4")
    idx.add(db, [f"r{i}" for i in range(len(db))])
    assert _recall(idx.search(qs, 10), exact) >= 0.9


def test_centered_save_load_roundtrip(concentrated, tmp_path):
    db, qs = concentrated
    idx = FlatIndex(dim=64, dtype="int8")
    idx.add(db, [f"r{i}" for i in range(len(db))])
    idx.save(str(tmp_path / "c"))
    back = FlatIndex.load(str(tmp_path / "c"))
    np.testing.assert_allclose(back.mean, idx.mean)
    assert back.search(qs[:4], 5) == idx.search(qs[:4], 5)
    # Incremental adds after reload quantize in the SAME pinned space.
    extra = db[:8] * -1.0
    back.add(extra / np.linalg.norm(extra, axis=1, keepdims=True),
             [f"x{i}" for i in range(8)])
    idx.add(extra / np.linalg.norm(extra, axis=1, keepdims=True),
            [f"x{i}" for i in range(8)])
    assert back.search(qs[:2], 5) == idx.search(qs[:2], 5)


def test_raw_checkpoint_loads_with_zero_mean(concentrated, tmp_path):
    """Pre-centering checkpoints (no mean in meta) pin zero on load so
    later adds cannot re-center over the existing raw codes."""
    import json

    db, _ = concentrated
    idx = FlatIndex(dim=64, dtype="int8", center=False)
    idx.add(db[:256], [f"r{i}" for i in range(256)])
    idx.save(str(tmp_path / "old"))
    meta_p = tmp_path / "old.meta.json"
    meta = json.loads(meta_p.read_text())
    meta.pop("mean", None)  # simulate a round-2 checkpoint
    meta_p.write_text(json.dumps(meta))
    back = FlatIndex.load(str(tmp_path / "old"))
    assert back.mean is not None and not back.mean.any()
    back.add(db[256:300], [f"r{i}" for i in range(256, 300)])
    assert not back.mean.any()


def test_add_quantized_pins_raw_semantics(concentrated):
    from memex_tpu.ops.quant import quantize_rows_int8
    import jax.numpy as jnp

    db, qs = concentrated
    idx = FlatIndex(dim=64, dtype="int8")
    q, s = quantize_rows_int8(jnp.asarray(db[:512]))
    idx.add_quantized(q, s, [f"r{i}" for i in range(512)])
    assert idx.mean is not None and not idx.mean.any()
    # Host adds after a device bulk stay in the raw space.
    idx.add(db[512:520], [f"r{i}" for i in range(512, 520)])
    assert not idx.mean.any()


class TestIVFCentering:
    def test_lifecycle_stays_consistent(self, concentrated):
        """build -> spill adds -> fold -> rebuild: one code space
        throughout, recall vs the f32 oracle holds at every step."""
        db, qs = concentrated
        n0 = 3072
        idx = IVFIndex(dim=64, n_clusters=16, nprobe=16, dtype="int8")
        idx.build(db[:n0], [f"r{i}" for i in range(n0)])
        assert idx.mean is not None and idx.mean.any()
        np.testing.assert_allclose(idx.spill.mean, idx.mean)

        def recall_now(n_live):
            exact = np.argsort(-(qs @ db[:n_live].T), axis=1)[:, :10]
            return _recall(idx.search(qs, 10), exact)

        assert recall_now(n0) >= 0.95
        idx.add(db[n0:], [f"r{i}" for i in range(n0, len(db))])
        assert recall_now(len(db)) >= 0.95
        folded = idx.fold_spill()
        assert folded > 0
        assert recall_now(len(db)) >= 0.95
        idx.rebuild()  # centered -> host path, re-pins a fresh mean
        assert idx.mean is not None
        assert recall_now(len(db)) >= 0.95

    def test_scores_are_true_cosines(self, concentrated):
        db, qs = concentrated
        idx = IVFIndex(dim=64, n_clusters=16, nprobe=16, dtype="int8")
        idx.build(db, [f"r{i}" for i in range(len(db))])
        hits = idx.search(qs[:4], 5)
        for qi in range(4):
            assert hits[qi], "no hits"
            for sid, score in hits[qi]:
                true = float(qs[qi] @ db[int(sid[1:])])
                assert abs(score - true) < 5e-3, (sid, score, true)

    def test_save_load_roundtrip(self, concentrated, tmp_path):
        db, qs = concentrated
        idx = IVFIndex(dim=64, n_clusters=16, nprobe=16, dtype="int8")
        idx.build(db[:3072], [f"r{i}" for i in range(3072)])
        idx.add(db[3072:3200], [f"r{i}" for i in range(3072, 3200)])
        idx.save(str(tmp_path / "ivf"))
        back = IVFIndex.load(str(tmp_path / "ivf"))
        np.testing.assert_allclose(back.mean, idx.mean)
        np.testing.assert_allclose(back.spill.mean, idx.mean)
        assert back.search(qs[:4], 5) == idx.search(qs[:4], 5)

    def test_centered_beats_raw_recall(self, concentrated):
        db, qs = concentrated
        exact = np.argsort(-(qs @ db.T), axis=1)[:, :10]
        ids = [f"r{i}" for i in range(len(db))]
        raw = IVFIndex(dim=64, n_clusters=16, nprobe=16, dtype="int8", center=False)
        raw.build(db, ids)
        cen = IVFIndex(dim=64, n_clusters=16, nprobe=16, dtype="int8")
        cen.build(db, ids)
        r_raw = _recall(raw.search(qs, 10), exact)
        r_cen = _recall(cen.search(qs, 10), exact)
        assert r_cen >= 0.95 and r_cen > r_raw, (r_raw, r_cen)


class TestCenteredLifecycleRegressions:
    """Advisor r3 findings: the centered code space must survive every
    lifecycle transition — rebuild() of FLOAT tiers (high) and spill
    compact() under an externally pinned mean (medium)."""

    def test_float32_rebuild_keeps_code_space(self, concentrated):
        """build() centers float tables too; rebuild() decodes the table
        via _all_vectors, which formerly added the mean back only for
        int8 — float rows re-entered rebuild in RESIDUAL space, were
        re-centered as a mixture with raw spill rows, and true top-1s
        scored ~q*mean too low afterwards."""
        db, qs = concentrated
        n0 = 3072
        idx = IVFIndex(dim=64, n_clusters=16, nprobe=16, dtype="float32")
        idx.build(db[:n0], [f"r{i}" for i in range(n0)])
        assert idx.mean is not None and idx.mean.any()
        idx.add(db[n0:], [f"r{i}" for i in range(n0, len(db))])  # spill
        idx.rebuild()  # mixes table + spill rows through _all_vectors

        exact = np.argsort(-(qs @ db.T), axis=1)[:, :10]
        rec = _recall(idx.search(qs, 10), exact)
        assert rec >= 0.95, rec
        # Scores must be true cosines (a residual-space row would sit
        # ~q*mean ~ 0.99 below its true score on this corpus).
        hits = idx.search(qs[:4], 5)
        for qi in range(4):
            for sid, score in hits[qi]:
                true = float(qs[qi] @ db[int(sid[1:])])
                assert abs(score - true) < 5e-3, (sid, score, true)

    def test_spill_compact_preserves_pinned_mean(self, concentrated):
        """IVF spill is built center=False with ivf.mean pinned onto it;
        compact() (auto at >25% dead) formerly went through delete_all(),
        which cleared the mean — surviving rows were re-coded in RAW
        space while search kept adding +q*mean, inflating them by ~1.0."""
        db, qs = concentrated
        n0 = 3072
        idx = IVFIndex(dim=64, n_clusters=16, nprobe=16, dtype="int8")
        idx.build(db[:n0], [f"r{i}" for i in range(n0)])
        idx.add(db[n0:], [f"r{i}" for i in range(n0, len(db))])
        assert idx.spill.count > 0
        # Delete >25% of the spill to force FlatIndex.compact().
        spill_ids = [f"r{i}" for i in range(n0, n0 + 600)]
        idx.delete(spill_ids)
        assert idx.spill.dead == 0  # compact ran
        np.testing.assert_allclose(idx.spill.mean, idx.mean)

        live = np.ones(len(db), dtype=bool)
        live[n0:n0 + 600] = False
        live_rows = np.nonzero(live)[0]
        exact_local = np.argsort(-(qs @ db[live_rows].T), axis=1)[:, :10]
        exact = live_rows[exact_local]
        rec = _recall(idx.search(qs, 10), exact)
        assert rec >= 0.95, rec
        # fold_spill scatters the compacted codes into the table: they
        # must land in the shared residual space (true cosines after).
        idx.fold_spill()
        hits = idx.search(qs[:4], 5)
        for qi in range(4):
            for sid, score in hits[qi]:
                true = float(qs[qi] @ db[int(sid[1:])])
                assert abs(score - true) < 5e-3, (sid, score, true)
