"""Randomized lifecycle fuzz: drive IVFIndex and FlatIndex through random
op sequences (add / delete / re-add / fold / rebuild / save+load) and check
every state against a dict oracle.

The round-2 reviews found five distinct ways the persistence/maintenance
paths could resurrect deleted rows or lose re-added ones; each had a
targeted regression test, but the class of bug is "unexpected op
INTERLEAVING", which is exactly what a seeded random walk covers. Bounded
sizes keep this hermetic-CPU fast.
"""

import numpy as np
import pytest

from memex_tpu.index import FlatIndex, IVFIndex


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


class Oracle:
    """id -> vector map with the index's documented semantics."""

    def __init__(self):
        self.live: dict[str, np.ndarray] = {}

    def add(self, ids, vecs):
        for sid, v in zip(ids, vecs):
            # Idempotent for live ids; re-add after delete takes the new row.
            if sid not in self.live:
                self.live[sid] = v

    def delete(self, ids):
        for sid in ids:
            self.live.pop(sid, None)

    def check(self, index, rng, d, k=10, probes=4):
        # Unified live-id count: IVF keeps `_live`; flat/sharded keep the
        # live id->row map (FlatIndex.count would include tombstones,
        # ShardedFlatIndex.count would not — don't touch either).
        live_ids = getattr(index, "_live", None)
        if live_ids is None:
            live_ids = index._id_to_row
        live_count = len(live_ids)
        assert live_count == len(self.live), (
            f"live {live_count} != oracle {len(self.live)}")
        if not self.live:
            return
        ids = sorted(self.live)
        sel = rng.choice(len(ids), min(probes, len(ids)), replace=False)
        for i in sel:
            sid = ids[i]
            hits = index.search(self.live[sid][None, :],
                                min(k, len(self.live)))[0]
            got = [h[0] for h in hits]
            assert got, f"no hits for live id {sid}"
            assert got[0] == sid, f"self-query top1 {got[0]} != {sid}"
            dead = [g for g in got if g not in self.live]
            assert not dead, f"dead ids returned: {dead}"


OPS = ("add", "delete", "readd", "maintain", "roundtrip")


def _run_fuzz(make_index, seed, tmp_path, steps=40, d=16):
    rng = np.random.default_rng(seed)
    idx = make_index()
    oracle = Oracle()
    next_id = 0
    deleted_pool: list[str] = []

    for step in range(steps):
        op = OPS[rng.integers(0, len(OPS))]
        if op == "add" or not oracle.live:
            n = int(rng.integers(1, 48))
            vecs = unit(rng, n, d)
            ids = [f"id{next_id + i}" for i in range(n)]
            next_id += n
            idx.add(vecs, ids)
            oracle.add(ids, vecs)
        elif op == "delete":
            ids = sorted(oracle.live)
            n = int(rng.integers(1, max(2, len(ids) // 3)))
            sel = [ids[i] for i in
                   rng.choice(len(ids), min(n, len(ids)), replace=False)]
            idx.delete(sel)
            oracle.delete(sel)
            deleted_pool.extend(sel)
        elif op == "readd" and deleted_pool:
            n = min(len(deleted_pool), int(rng.integers(1, 8)))
            sel = [deleted_pool.pop() for _ in range(n)]
            vecs = unit(rng, n, d)
            idx.add(vecs, sel)
            for sid, v in zip(sel, vecs):
                oracle.live[sid] = v  # re-add takes the NEW vector
        elif op == "maintain":
            if hasattr(idx, "fold_spill") and rng.integers(0, 2):
                idx.fold_spill()
            elif hasattr(idx, "rebuild"):
                idx.rebuild()
            else:
                idx.compact()
        elif op == "roundtrip":
            path = str(tmp_path / f"fz{seed}")
            idx.save(path)
            idx = type(idx).load(path)
            idx._interpret = False
            if getattr(idx, "needs_recovery", False):
                # A device-built int8 base is policy-skipped at save
                # (multi-GB device fetches are avoided);
                # the runtime re-streams from SQL. Simulate that re-stream
                # from the oracle — idempotent adds must dedupe it.
                ids = sorted(oracle.live)
                if ids:
                    idx.add(np.stack([oracle.live[s] for s in ids]), ids)
                idx.needs_recovery = False
        if step % 5 == 4 or op == "roundtrip":
            oracle.check(idx, rng, d)
    oracle.check(idx, rng, d, probes=10)


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_fuzz_flat_lifecycle(tmp_path, seed):
    _run_fuzz(lambda: FlatIndex(dim=16), seed, tmp_path)


@pytest.mark.parametrize("seed", [2, 11])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fuzz_ivf_lifecycle(tmp_path, seed, dtype):
    _run_fuzz(
        lambda: IVFIndex(dim=16, n_clusters=4, nprobe=4, dtype=dtype),
        seed, tmp_path,
    )


def _run_fuzz_sharded(make_index, seed, tmp_path, steps=30, d=16):
    """Sharded variant: roundtrip = save + restore into a FRESH instance
    (the mesh stores' restore contract), recovery simulated from the
    oracle when the restored index flags it."""
    rng = np.random.default_rng(seed)
    idx = make_index()
    oracle = Oracle()
    next_id = 0
    deleted_pool: list[str] = []

    for step in range(steps):
        op = OPS[rng.integers(0, len(OPS))]
        if op == "add" or not oracle.live:
            n = int(rng.integers(1, 40))
            vecs = unit(rng, n, d)
            ids = [f"id{next_id + i}" for i in range(n)]
            next_id += n
            idx.add(vecs, ids)
            oracle.add(ids, vecs)
        elif op == "delete":
            ids = sorted(oracle.live)
            n = int(rng.integers(1, max(2, len(ids) // 3)))
            sel = [ids[i] for i in
                   rng.choice(len(ids), min(n, len(ids)), replace=False)]
            idx.delete(sel)
            oracle.delete(sel)
            deleted_pool.extend(sel)
        elif op == "readd" and deleted_pool:
            n = min(len(deleted_pool), int(rng.integers(1, 6)))
            sel = [deleted_pool.pop() for _ in range(n)]
            vecs = unit(rng, n, d)
            idx.add(vecs, sel)
            for sid, v in zip(sel, vecs):
                oracle.live[sid] = v
        elif op == "maintain":
            if hasattr(idx, "fold_spill") and rng.integers(0, 2):
                idx.fold_spill()
            elif hasattr(idx, "rebuild"):
                idx.rebuild()
            else:
                idx.compact()
        elif op == "roundtrip":
            path = str(tmp_path / f"sfz{seed}")
            idx.save(path)
            fresh = make_index()
            fresh.restore(path)
            idx = fresh
            if getattr(idx, "needs_recovery", False) or (
                    hasattr(idx, "_live")
                    and len(idx._live) < len(oracle.live)):
                ids = sorted(oracle.live)
                if ids:
                    idx.add(np.stack([oracle.live[s] for s in ids]), ids)
                if hasattr(idx, "needs_recovery"):
                    idx.needs_recovery = False
        if step % 5 == 4 or op == "roundtrip":
            oracle.check(idx, rng, d)
    oracle.check(idx, rng, d, probes=8)


@pytest.fixture
def mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]), ("shard",))


@pytest.mark.parametrize("seed", [3, 17])
def test_fuzz_sharded_flat_lifecycle(tmp_path, mesh, seed):
    from memex_tpu.index import ShardedFlatIndex

    _run_fuzz_sharded(
        lambda: ShardedFlatIndex(dim=16, mesh=mesh, capacity_per_shard=64,
                                 dtype="int8"),
        seed, tmp_path,
    )


@pytest.mark.parametrize("seed", [5])
def test_fuzz_sharded_ivf_lifecycle(tmp_path, mesh, seed):
    from memex_tpu.index.sharded_ivf import ShardedIVFIndex

    _run_fuzz_sharded(
        lambda: ShardedIVFIndex(dim=16, mesh=mesh, n_clusters=4, nprobe=4),
        seed, tmp_path, steps=24,
    )


@pytest.mark.parametrize("seed", [4, 13])
def test_fuzz_ivf_refine_lifecycle(tmp_path, seed):
    """Residual-refine store through the same random walk: residual codes
    must survive every interleaving (fold/rebuild/save/load) without
    resurrecting rows or losing the rerank's id mapping."""
    _run_fuzz(
        lambda: IVFIndex(dim=16, n_clusters=4, nprobe=4, dtype="int8", refine=True),
        seed, tmp_path,
    )


@pytest.mark.parametrize("seed", [9])
def test_fuzz_flat_refine_lifecycle(tmp_path, seed):
    _run_fuzz(lambda: FlatIndex(dim=16, dtype="int8",
                                refine=True), seed, tmp_path)


@pytest.mark.parametrize("seed", [19])
def test_fuzz_sharded_ivf_refine_lifecycle(tmp_path, mesh, seed):
    from memex_tpu.index.sharded_ivf import ShardedIVFIndex

    _run_fuzz_sharded(
        lambda: ShardedIVFIndex(dim=16, mesh=mesh, n_clusters=4, nprobe=4, refine=True),
        seed, tmp_path, steps=24,
    )
