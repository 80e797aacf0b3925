"""Flat scan tests: the fused Pallas (Triton) kernel in interpret mode, the
plain XLA path beside it, and the one function that chooses between them.

Interpret mode runs the kernel's program body on the CPU, so its chunk
walk, masks and slot fold are covered here; the compiled kernel runs on
the GPU in `chip_smoke.py` and in the tests marked `gpu`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from memex_tpu.index.flat import FlatIndex, device_search, scan_mode
from memex_tpu.ops.quant import (np_quantize_rows_int4, quantize_rows_int8,
                                 route_union)
from memex_tpu.ops.scan_topk import (BANK, MAX_K, _SMEM, chunk_plan,
                                     n_slices, reference_topk, scan_candidates,
                                     scan_topk, slice_bounds, use_kernel)
from memex_tpu.ops.topk import blockwise_topk, exact_topk, score_topk

IMPLS = ["kernel", "xla"]


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def clustered(rng, n, d, c=16, noise=0.5):
    cents = unit(rng, c, d)
    v = cents[rng.integers(0, c, n)] + noise / np.sqrt(d) * rng.standard_normal(
        (n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def recall(got_ids, want_ids):
    return float(np.mean([len(set(g) & set(w)) / len(w)
                          for g, w in zip(got_ids, want_ids)]))


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def flat(dtype, impl, **kw):
    idx = FlatIndex(dim=kw.pop("dim", 64), dtype=dtype, **kw)
    idx._interpret = impl == "kernel"
    return idx


class TestXlaTopk:
    def test_blockwise_equals_exact(self, rng):
        scores = jnp.asarray(rng.standard_normal((4, 10000), dtype=np.float32))
        ev, ei = exact_topk(scores, 7)
        bv, bi = blockwise_topk(scores, 7, block=1024)
        np.testing.assert_array_equal(np.asarray(ei), np.asarray(bi))
        np.testing.assert_allclose(np.asarray(ev), np.asarray(bv))

    def test_count_masking(self, rng):
        scores = jnp.asarray(rng.standard_normal((2, 4096), dtype=np.float32))
        _, idx = exact_topk(scores, 5, count=100)
        assert np.asarray(idx).max() < 100

    def test_score_topk_shapes(self, rng):
        db, q = unit(rng, 2048, 64), unit(rng, 3, 64)
        vals, idx = score_topk(jnp.asarray(db), jnp.asarray(q), 5)
        assert vals.shape == (3, 5) and idx.shape == (3, 5)


class TestQuant:
    def test_quantize_roundtrip_error(self, rng):
        db = unit(rng, 256, 64)
        q8, scales = quantize_rows_int8(jnp.asarray(db))
        recon = np.asarray(q8, np.float32) * np.asarray(scales)[:, None]
        assert np.abs(recon - db).max() <= 1.0 / 127.0

    def test_int4_pack_roundtrip(self, rng):
        db = unit(rng, 128, 64)
        p_np, s_np = np_quantize_rows_int4(db)
        assert p_np.shape == (32, 128)  # transposed [D/2, N]
        # Unpack (b = 16*hi + lo signed; lo = col j, hi = col j + D/2).
        b = p_np.T.astype(np.int32)
        hi = (b + 8) >> 4
        lo = b - 16 * hi
        assert np.abs(lo).max() <= 7 and np.abs(hi).max() <= 7
        recon = np.concatenate([lo, hi], axis=1).astype(np.float32) * s_np[:, None]
        assert np.abs(recon - db).max() <= 1.0 / 7.0 + 1e-6

    def test_route_union_dedupes(self, rng):
        cents = jnp.asarray(unit(rng, 16, 64))
        qs = jnp.asarray(unit(rng, 8, 64))
        clist, nact = route_union(cents, qs, 6)
        clist, nact = np.asarray(clist), int(np.asarray(nact)[0])
        qc = np.asarray(qs) @ np.asarray(cents).T
        want = set()
        for q in range(8):
            want.update(np.argsort(-qc[q])[:6].tolist())
        assert nact == len(want)
        assert set(clist[:nact].tolist()) == want
        assert np.all(np.diff(clist[:nact]) > 0)
        assert sorted(clist.tolist()) == list(range(16))


class TestFlatSearch:
    """FlatIndex through the kernel (interpreted) and the XLA scan."""

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
    def test_recall_vs_oracle(self, rng, dtype, impl):
        db, qs = clustered(rng, 3000, 64), unit(rng, 8, 64)
        idx = flat(dtype, impl)
        idx.add(db, [str(i) for i in range(len(db))])
        exact = np.argsort(-(qs @ db.T), axis=1)[:, :10]
        got = [[int(s) for s, _ in h] for h in idx.search(qs, 10)]
        assert recall(got, exact) >= 0.9

    @pytest.mark.parametrize("impl", IMPLS)
    def test_unfilled_capacity_is_never_returned(self, rng, impl):
        idx = flat("float32", impl, capacity=8192)
        db = unit(rng, 300, 64)
        idx.add(db, [str(i) for i in range(300)])
        hits = idx.search(unit(rng, 4, 64), 50)
        assert all(len(h) == 50 for h in hits)
        assert all(0 <= int(s) < 300 for h in hits for s, _ in h)

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_tombstones_never_returned(self, rng, dtype, impl):
        db = unit(rng, 2048, 64)
        idx = flat(dtype, impl)
        idx.add(db, [str(i) for i in range(2048)])
        q = db[:3]
        dead = [str(i) for i in range(3)]
        dead += [str(i) for i in np.argsort(-(q @ db.T), axis=1)[:, 1:40].ravel()]
        idx.delete(sorted(set(dead))[:400])
        gone = set(sorted(set(dead))[:400])
        for h in idx.search(q, 10):
            assert len(h) == 10 and not {s for s, _ in h} & gone

    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("q_n", [1, 17])
    def test_query_batch_padding(self, rng, impl, q_n):
        db = unit(rng, 2048, 64)
        idx = flat("int8", impl)
        idx.add(db, [str(i) for i in range(2048)])
        hits = idx.search(db[:q_n], 5)
        assert len(hits) == q_n
        assert [h[0][0] for h in hits] == [str(i) for i in range(q_n)]

    @pytest.mark.parametrize("impl", IMPLS)
    def test_refine_rerank_gives_true_cosines(self, rng, impl):
        db = clustered(rng, 2048, 64)
        idx = flat("int8", impl, refine=True)
        idx.add(db, [str(i) for i in range(2048)])
        qs = unit(rng, 4, 64)
        for qi, hits in enumerate(idx.search(qs, 10)):
            for sid, score in hits:
                assert abs(score - float(qs[qi] @ db[int(sid)])) < 1e-3
            want = np.argsort(-(qs[qi] @ db.T))[:10]
            assert recall([[int(s) for s, _ in hits]], [want]) >= 0.9

    @pytest.mark.parametrize("impl", IMPLS)
    def test_grow_keeps_rows_searchable(self, rng, impl):
        idx = flat("bfloat16", impl)
        db = unit(rng, 5000, 64)  # > MIN_CAPACITY: two capacity doublings
        idx.add(db[:1000], [str(i) for i in range(1000)])
        idx.add(db[1000:], [str(i) for i in range(1000, 5000)])
        assert idx.capacity >= 5000
        hits = idx.search(db[[10, 4990]], 1)
        assert [h[0][0] for h in hits] == ["10", "4990"]


class TestKernelVsReference:
    """The kernel against its plain-JAX twin (same arithmetic)."""

    @pytest.mark.parametrize("mode", ["bf16", "int8q"])
    def test_scores_match_reference(self, rng, mode):
        db = clustered(rng, 4096, 128)
        qs = jnp.asarray(unit(rng, 8, 128))
        if mode == "int8q":
            buf, sc = quantize_rows_int8(jnp.asarray(db))
        else:
            buf, sc = jnp.asarray(db), None
        kv, ki = scan_topk(buf, qs, sc, None, 4096, 10, mode=mode,
                           interpret=True)
        rv, ri = reference_topk(buf, qs, sc, None, 4096, 4096, mode=mode)
        ref = np.zeros((8, 4096), np.float32)
        np.put_along_axis(ref, np.asarray(ri), np.asarray(rv), axis=1)
        got = np.take_along_axis(ref, np.asarray(ki), axis=1)
        if mode == "int8q":  # the int32 dot is exact: float rounding only
            np.testing.assert_allclose(np.asarray(kv), got, rtol=1e-5)
        else:  # bf16 inputs, f32 sums in another order
            np.testing.assert_allclose(np.asarray(kv), got, atol=1e-3)

    @pytest.mark.parametrize("mode", ["bf16", "int8q"])
    def test_candidates_cover_reference_topk(self, rng, mode):
        db = clustered(rng, 8192, 64)
        qs = jnp.asarray(unit(rng, 16, 64))
        if mode == "int8q":
            buf, sc = quantize_rows_int8(jnp.asarray(db))
        else:
            buf, sc = jnp.asarray(db), None
        _, ki = scan_topk(buf, qs, sc, None, 8192, 10, mode=mode,
                          interpret=True)
        _, ri = reference_topk(buf, qs, sc, None, 8192, 10, mode=mode)
        assert recall(np.asarray(ki), np.asarray(ri)) >= 0.99

    def test_masked_contraction_piece(self, rng):
        """A width that is not a multiple of 16 is scanned as one padded
        power-of-two piece with masked loads."""
        db = unit(rng, 2048, 40)
        qs = jnp.asarray(db[:4])
        kv, ki = scan_topk(jnp.asarray(db), qs, None, None, 2048, 5,
                           mode="bf16", interpret=True)
        rv, ri = reference_topk(jnp.asarray(db), qs, None, None, 2048, 5,
                                mode="bf16")
        np.testing.assert_array_equal(np.asarray(ki)[:, 0], np.arange(4))
        np.testing.assert_allclose(np.asarray(kv), np.asarray(rv), atol=1e-3)

    def test_candidate_bank_shape(self, rng):
        buf = jnp.asarray(unit(rng, 4096, 64))
        vals, idx = scan_candidates(buf, jnp.asarray(unit(rng, 3, 64)), None,
                                    None, 1000, mode="bf16", interpret=True)
        s, _ = chunk_plan(64, 4)
        assert vals.shape == idx.shape == (3, n_slices(1, 4096, s) * s)
        live = np.asarray(vals) > -1e29
        assert np.asarray(idx)[live].max() < 1000

    def test_alive_mask_inside_kernel(self, rng):
        db = unit(rng, 2048, 64)
        alive = np.ones(2048, np.float32)
        alive[:64] = 0
        _, ki = scan_topk(jnp.asarray(db), jnp.asarray(db[:8]), None,
                          jnp.asarray(alive), 2048, 20, mode="bf16",
                          interpret=True)
        assert np.asarray(ki).min() >= 64

    def test_device_search_rerank_matches_xla(self, rng):
        db = clustered(rng, 2048, 64)
        buf, sc = quantize_rows_int8(jnp.asarray(db))
        qs = jnp.asarray(unit(rng, 4, 64))
        out = [device_search(buf, sc, None, 2048, qs, None, None, k=5,
                             k_ret=64, kernel=kern, mode="int8q",
                             interpret=kern)
               for kern in (True, False)]
        assert recall(np.asarray(out[0][1]), np.asarray(out[1][1])) >= 0.95

    def test_sharded_kernel_matches_xla(self, rng):
        from jax.sharding import Mesh

        from memex_tpu.index.sharded import ShardedFlatIndex

        mesh = Mesh(np.array(jax.devices()[:2]), ("shard",))
        db = unit(rng, 1500, 32)
        res = []
        for interp in (True, False):
            idx = ShardedFlatIndex(dim=32, mesh=mesh, capacity_per_shard=1024,
                                   dtype="int8")
            idx._interpret = interp
            idx.add(db, [str(i) for i in range(1500)])
            res.append(idx.search(db[:4], 5))
        for a, b in zip(*res):
            assert a[0][0] == b[0][0]
            assert len({s for s, _ in a} & {s for s, _ in b}) >= 4


class TestKernelPlan:
    """Block geometry: pure Python, no compilation."""

    @pytest.mark.parametrize("count", [0, 1, 127, 128, 1000, 4096])
    def test_slice_bounds_cover_live_prefix(self, count):
        p, s = 8, 128
        b = np.asarray(slice_bounds(count, p, s))
        assert b[0] == 0 and b[-1] == count and len(b) == p + 1
        assert np.all(np.diff(b) >= 0)
        assert np.all(b[:-1][np.diff(b) > 0] % s == 0)  # slices start on chunks

    @pytest.mark.parametrize("d", [384, 768, 1024])
    @pytest.mark.parametrize("itemsize", [1, 2, 4])
    def test_chunk_plan_fits_shared_memory(self, d, itemsize):
        s, stages = chunk_plan(d, itemsize)
        assert s & (s - 1) == 0 and 16 <= s <= 128
        assert 1 <= stages <= 3
        assert stages * s * d * itemsize <= _SMEM or s == 16

    @pytest.mark.parametrize("q_tiles", [1, 8])
    def test_n_slices_fills_card_within_bank(self, q_tiles):
        p = n_slices(q_tiles, 1 << 21, 128)
        assert p * 128 <= BANK
        assert p * q_tiles >= 132 or p == BANK // 128


class TestSelection:
    """ops/scan_topk.use_kernel: the one choice of scan implementation."""

    @pytest.mark.parametrize("backend,mode,k,want", [
        ("gpu", "int8q", 10, True),
        ("gpu", "bf16", MAX_K, True),
        ("gpu", "bf16", MAX_K + 1, False),
        ("gpu", "exact", 10, False),
        ("cpu", "int8q", 10, False),
        ("cpu", "bf16", 10, False),
    ])
    def test_use_kernel(self, backend, mode, k, want):
        assert use_kernel(mode, k, backend) is want

    def test_default_backend_here_is_xla(self):
        assert use_kernel("int8q", 10) is False  # tests run on the CPU

    @pytest.mark.parametrize("dtype,qq,prec,want", [
        ("float32", True, "default", "bf16"),
        ("float32", True, "highest", "exact"),
        ("int8", True, "default", "int8q"),
        ("int4", False, "default", "bf16"),
    ])
    def test_scan_mode(self, dtype, qq, prec, want):
        assert scan_mode(dtype, qq, prec) == want

    @pytest.mark.parametrize("opt", ["use_fused=1", "scan_int4=1",
                                     "block_n=1024"])
    def test_removed_uri_option_is_named(self, tmp_path, opt):
        from memex_tpu.store import get_vector_storage

        name = opt.split("=")[0]
        with pytest.raises(ValueError, match=name):
            get_vector_storage(f"tpu+ivf://{tmp_path}/v?{opt}", "c", dim=16)


class TestPrecisionPins:
    """f32 products that are meant to be exact name HIGHEST precision:
    on a GPU a default-precision f32 dot may run in TF32."""

    @staticmethod
    def _hlo(fn, *args):
        return jax.jit(fn).lower(*args).as_text()

    def test_ivf_routing_and_exact_scan(self):
        from memex_tpu.index.ivf import _ivf_search

        C, M, D = 4, 16, 8
        args = (jnp.zeros((C, D)), jnp.zeros((C, M, D)), jnp.ones((C, M)),
                jnp.full((C,), M, jnp.int32), jnp.zeros((2, D)),
                jnp.float32(4.0))
        hlo = self._hlo(lambda *a: _ivf_search(*a, nprobe=2, k=3), *args)
        dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
        assert len(dots) >= 2
        assert all("HIGHEST" in ln for ln in dots), dots

    def test_sharded_ivf_routing_and_exact_scan(self):
        from jax.sharding import Mesh

        from memex_tpu.index.sharded_ivf import make_ivf_search_fn

        mesh = Mesh(np.array(jax.devices()[:2]), ("shard",))
        C, M, D = 4, 16, 8
        fn = make_ivf_search_fn(mesh, "shard", C // 2, M, nprobe=2, kk=3)
        hlo = fn.lower(jnp.zeros((C, D)), jnp.zeros((C, M, D)),
                       jnp.ones((C, M)), jnp.full((C,), M, jnp.int32),
                       jnp.zeros((2, D)), jnp.float32(4.0)).as_text()
        dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
        assert len(dots) >= 2
        assert all("HIGHEST" in ln for ln in dots), dots

    def test_ivf_margin_masks_trailing_probes(self):
        from memex_tpu.index.ivf import _ivf_search

        D, M = 4, 8
        cents = jnp.eye(4, D)
        data = jnp.broadcast_to(jnp.eye(4, D)[:, None, :], (4, M, D))
        q = jnp.asarray([[1.0, 0.1, 0.0, 0.0]])
        q = q / jnp.linalg.norm(q)
        sizes = jnp.full((4,), M, jnp.int32)
        args = (cents, data, jnp.ones((4, M)), sizes, q)
        _, cl_all, _ = _ivf_search(*args, jnp.float32(4.0), nprobe=2, k=2 * M)
        _, cl_cut, _ = _ivf_search(*args, jnp.float32(0.5), nprobe=2, k=M)
        assert set(np.asarray(cl_all).ravel().tolist()) == {0, 1}
        assert set(np.asarray(cl_cut).ravel().tolist()) == {0}
