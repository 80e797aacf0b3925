"""ShardedIVFIndex — IVF partitions sharded across a device mesh.

The 100M-row tier (BASELINE config 5: "100M-vector corpus with
int8-quantized shards across a mesh"): 100M x 384 int8 is ~38 GB, and
the flat mesh index would scan all of it per batch. Here k-means clusters
are sharded CONTIGUOUSLY over the mesh axis (device p owns clusters
[p*Cp, (p+1)*Cp) and their [Cp, M, D] bucket block), centroids are
replicated, and a search is ONE SPMD dispatch:

  1. every device routes the (replicated) query batch on the replicated
     centroid table — no communication;
  2. each device masks its rows down to ITS clusters in the batch's
     union of probes — expert-style routing where the "experts" are
     cluster shards (SURVEY.md §2.3 item 2);
  3. per-shard top-k candidates carry GLOBAL bucket coordinates and merge
     with one all_gather (parallel/collectives.py).

The masked scan scores every row of the shard and masks the unprobed
clusters, so per-batch device traffic is the whole shard; a probe-only
scan that reads |local ∩ union(probes)| * M * D bytes is ROADMAP work.

Build is all-device and SPMD: k-means on a replicated sample, blockwise
assignment over the row-sharded corpus, and a global scatter into the
cluster-sharded bucket table (XLA GSPMD inserts the all-to-all). The
corpus never transits the host. Streaming adds spill to a mesh-sharded
flat index (exact scan, collective merge) and fold back in on rebuild().

Replaces the reference's scale-out answer — delegation to an external
OpenSearch cluster (lib/libmemex/src/storage/mod.rs:122-133,
storage/opensearch.rs) — with the index itself spanning the mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..log import get_logger
from ..ops.quant import prune_probes
from ..ops.topk import blockwise_topk
from ..parallel.collectives import merge_topk_across
from .ivf import (IVFIndex, _capacity_fill, _topk_clusters, bucket_pack_dest,
                  kmeans_assign, kmeans_fit)
from .sharded import ShardedFlatIndex

logger = get_logger(__name__)

NEG_INF = -1e30


def _top_with_offset(merged: list[dict], off, k: int) -> list[list[tuple]]:
    """Top-k per query with the centered-storage q.mean correction applied
    on the way out (rank-neutral: the offset is query-constant)."""
    out = []
    for qi, m in enumerate(merged):
        top = sorted(m.items(), key=lambda kv: -kv[1])[:k]
        if off is not None:
            o = float(off[qi])
            top = [(sid, v + o) for sid, v in top]
        out.append(top)
    return out


def make_ivf_search_fn(mesh: Mesh, axis: str, Cp: int, M: int, nprobe: int,
                       kk: int, refine: bool = False):
    """Jitted SPMD search: (centroids [C,D], data [C,M,D], rscales [C,M],
    sizes [C], [resid [C,M,D], resid_scales [C,M] when refine,] queries
    [Q,D], margin [] f32) -> (vals [Q,kk], gidx [Q,kk] global bucket
    coords), replicated. `margin` is the DYNAMIC prune scalar
    (ops/quant.prune_probes semantics; 4.0 = keep-all sentinel), so
    retuning or calibrating the pruning operating point reuses this
    executable instead of recompiling the SPMD program.

    refine (r4 verdict item 6): each shard re-scores its OWN top-kk
    candidates at ~14 effective bits (base int8 code + int8 residual
    code, HIGHEST-precision dot) BEFORE the collective merge — the
    residual gather is [Q, kk, D] bytes per shard, negligible next to
    the probed-union scan, and no extra collective is needed because the
    merge already carries kk scores per shard. This is the sharded twin
    of IVFIndex's refine rerank (ivf._exact_topk_rerank): without it the
    100M tier had no route to f32-fidelity recall (plain int8 tie-recall
    0.7234 on realtext)."""

    def local_search(centroids, data, rscales, sizes, queries, margin,
                     resid=None, resid_scales=None):
        # Per-device shapes: data [Cp, M, D], sizes [Cp]; centroids/queries
        # replicated. Routing is recomputed on every device — cheaper than
        # communicating probe tables.
        shard = jax.lax.axis_index(axis)
        # f32 routing at HIGHEST precision (near-tied centroid scores
        # would otherwise misroute probes; see ivf._ivf_search).
        qc = jnp.einsum("qd,cd->qc", queries, centroids,
                        precision=jax.lax.Precision.HIGHEST)
        top_vals, probes = jax.lax.top_k(qc, nprobe)   # global cluster ids
        # Margin prune: drop a query's long-tail probes (the global-C
        # sentinel falls outside every shard's window below).
        probes = prune_probes(top_vals, probes, margin,
                              Cp * int(mesh.shape[axis]))
        lo = shard * Cp
        local = jnp.where((probes >= lo) & (probes < lo + Cp),
                          probes - lo, Cp)              # OOB -> dropped
        mask = jnp.zeros((Cp,), jnp.int32).at[local.reshape(-1)].set(
            1, mode="drop")
        # Dense masked scan of this shard's probed union: every query
        # scores every row of a cluster any query of the batch probed.
        flat_rows = data.reshape(Cp * M, -1)
        if data.dtype == jnp.float32:
            # Exact tier: HIGHEST, or the f32 product may run in TF32.
            scores = jnp.einsum("qd,nd->qn", queries, flat_rows,
                                precision=jax.lax.Precision.HIGHEST)
        else:
            scores = jnp.einsum(
                "qd,nd->qn", queries.astype(jnp.bfloat16),
                flat_rows.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ) * rscales.reshape(1, Cp * M)
        col = jnp.arange(Cp * M)
        cluster_of = col // M
        ok = (jnp.take(mask, cluster_of) > 0) & (
            col % M < jnp.take(sizes, cluster_of))
        scores = jnp.where(ok[None, :], scores, NEG_INF)
        vals, flat_idx = blockwise_topk(scores, min(kk, Cp * M))
        if vals.shape[1] < kk:  # tiny shards: pad to the merge width
            pad = kk - vals.shape[1]
            vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=NEG_INF)
            flat_idx = jnp.pad(flat_idx, ((0, 0), (0, pad)))
        cl, sl = flat_idx // M, flat_idx % M
        if refine:
            # In-shard residual rerank: reconstruct each local candidate
            # at base + residual precision and redo the dot exactly. The
            # refined scores ride the existing merge — sentinel lanes
            # (vals <= -1e29) keep their sentinel so the host filter and
            # the merge ordering still drop them.
            rows = data[cl, sl].astype(jnp.float32) * rscales[cl, sl][..., None]
            rows = rows + (resid[cl, sl].astype(jnp.float32)
                           * resid_scales[cl, sl][..., None])
            scores = jnp.einsum("qd,qkd->qk", queries.astype(jnp.float32),
                                rows, precision=jax.lax.Precision.HIGHEST)
            vals = jnp.where(vals > -1e29, scores, vals)
        gidx = (cl + lo) * M + sl
        return merge_topk_across(vals, gidx, axis, kk)

    if refine:
        def entry(centroids, data, rscales, sizes, resid, resid_scales,
                  queries, margin):
            return local_search(centroids, data, rscales, sizes, queries,
                                margin, resid, resid_scales)

        in_specs = (P(), P(axis, None, None), P(axis, None), P(axis),
                    P(axis, None, None), P(axis, None), P(), P())
    else:
        entry = local_search
        in_specs = (P(), P(axis, None, None), P(axis, None), P(axis), P(),
                    P())
    shmapped = jax.shard_map(
        entry,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P()),
        check_vma=False,  # outputs replicated post-all_gather
    )
    return jax.jit(shmapped)


def make_exact_search_fn(mesh: Mesh, axis: str, Cp: int, M: int, kk: int):
    """Bounded tombstone-shortfall fallback: ONE exact SPMD pass over the
    whole bucket table (no routing, any kk) with collective
    top-k merge. O(corpus) compute in a single dispatch — the query-path
    answer when tombstones crowd the probed candidates; the
    retrain that actually removes the tombstones runs on the worker
    (round-2 verdict: search() used to call rebuild() inline)."""

    def local(data, rscales, sizes, queries):
        shard = jax.lax.axis_index(axis)
        flat = data.reshape(Cp * M, -1)
        scores = jnp.einsum(
            "qd,nd->qn", queries.astype(jnp.bfloat16),
            flat.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ) * rscales.reshape(1, Cp * M)
        col = jnp.arange(Cp * M)
        ok = col % M < jnp.take(sizes, col // M)
        scores = jnp.where(ok[None, :], scores, NEG_INF)
        vals, fidx = blockwise_topk(scores, min(kk, Cp * M))
        if vals.shape[1] < kk:  # tiny shards: pad to the merge width
            pad = kk - vals.shape[1]
            vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=NEG_INF)
            fidx = jnp.pad(fidx, ((0, 0), (0, pad)))
        gidx = shard * (Cp * M) + fidx.astype(jnp.int32)
        return merge_topk_across(vals, gidx, axis, kk)

    shmapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(shmapped)


class ShardedIVFIndex:
    """Mesh-sharded IVF with device-side build and collective merge.

    Single-device semantics match IVFIndex (tests assert equivalence on
    the virtual CPU mesh); at P shards both HBM capacity and probe
    bandwidth scale with P. int8 storage only (the tier exists to fit
    big corpora)."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        axis: str = "shard",
        n_clusters: int = 256,
        nprobe: int = 32,
        bucket_factor: float = 2.0,
        seed: int = 0,
        prune_margin: float | None = None,
        rerank: int | None = None,
        refine: bool = False,
        center: bool | None = None,
    ):
        self.dim = dim
        self.mesh = mesh
        # Anisotropy-corrected storage (same contract as IVFIndex/FlatIndex
        # `center`): table + spill codes quantize v - mean, and the
        # query-constant q.mean is restored host-side after the merge
        # (rank-neutral). On cos≈0.99+ corpora raw int8 resolution (~1e-2)
        # exceeds the informative gaps; centered codes put quantization
        # error at the residual scale (measured on the single-chip tier:
        # recall 0.884 -> 0.953). Device-only builds pin mean=0
        # (byte-identical to uncentered).
        self.center = True if center is None else bool(center)
        self.mean: np.ndarray | None = None  # pinned at first host ingest
        # Residual-refinement store (r4 verdict item 6; same contract as
        # IVFIndex.refine): a cluster-sharded [C, M, D] int8 table of
        # quantization residuals, read only by the per-shard rerank in
        # make_ivf_search_fn. Host-ingest builds derive residuals from the
        # f32 source; streaming adds land in the spill WITHOUT residuals
        # (zero residual = plain-int8 rerank for those rows) until a
        # rebuild — table rows keep their residuals through rebuild().
        self.refine = bool(refine)
        if self.refine and rerank is None:
            rerank = 256
        self.rerank = None if rerank is None else min(int(rerank), 512)
        # Opt-in routing prune (see ops/quant.prune_probes): drops a
        # query's long-tail probes; per-shard unions shrink ~1:1 into
        # scan bytes. nprobe stays the recall-side upper bound.
        self.prune_margin = prune_margin
        self.axis = axis
        self.P = int(mesh.shape[axis])
        # Cluster count must split evenly over the mesh axis.
        self.C = -(-n_clusters // self.P) * self.P
        self.Cp = self.C // self.P
        self.nprobe = min(nprobe, self.C)
        self.bucket_factor = bucket_factor
        self.seed = seed
        self.dtype = "int8"
        self._rep = NamedSharding(mesh, P())
        self._c_sh = NamedSharding(mesh, P(axis, None, None))   # data
        self._cm_sh = NamedSharding(mesh, P(axis, None))        # rscales/rowids
        self._c1_sh = NamedSharding(mesh, P(axis))              # sizes
        self._row_sh = NamedSharding(mesh, P(axis, None))       # corpus rows
        self._vec_sh = NamedSharding(mesh, P(axis))

        self.centroids: jnp.ndarray | None = None
        self.data: jnp.ndarray | None = None       # [C, M, D] int8, sharded
        self.rscales: jnp.ndarray | None = None    # [C, M] f32
        self.sizes: jnp.ndarray | None = None      # [C] int32
        self.resid: jnp.ndarray | None = None          # [C, M, D] int8 (refine)
        self.resid_scales: jnp.ndarray | None = None   # [C, M] f32 (refine)
        self._host_resid: np.ndarray | None = None     # row-aligned shadows
        self._host_resid_scales: np.ndarray | None = None
        self._rowids_dev = None                    # [C, M] int32, sharded
        self.rowids: np.ndarray | None = None      # host cache
        self.ids: list = []
        self.spill = ShardedFlatIndex(
            dim, mesh, axis=axis, dtype="int8")
        self._deleted: set = set()
        self._live: set = set()
        # True once add() nulled stale table id entries on a delete->re-add;
        # gates the null-row exclusion in rebuild/save masks.
        self._ids_nulled = False
        self._search_cache: dict = {}
        self._exact_cache: dict = {}
        # Set (never acted on) by the search path: a shortfall query was
        # served by the exact fallback and the table wants a rebuild. The
        # store schedules a worker Maintain task when it sees this.
        self.maintenance_needed = False
        self._host_codes: np.ndarray | None = None  # [N] order as self.ids
        self._host_scales: np.ndarray | None = None
        self._base_dirty = False
        self._ckpt_path: str | None = None

    @property
    def count(self) -> int:
        return len(self._live)

    def _pin_mean(self, vectors: np.ndarray | None) -> None:
        """Pin the shared quantization center (idempotent; must run before
        the first code lands in the table or the spill — the spill holds
        centered rows too, so the merge compares like with like)."""
        if self.mean is not None:
            return
        if self.center and vectors is not None and len(vectors):
            self.mean = np.asarray(vectors, np.float32).mean(axis=0)
        else:
            self.mean = np.zeros((self.dim,), np.float32)
        assert self.spill.count == 0 or not self.mean.any(), \
            "spill holds raw codes; cannot center after the fact"

    def _centered(self, vectors: np.ndarray) -> np.ndarray:
        if self.mean is not None and self.mean.any():
            return vectors - self.mean
        return vectors

    # -- build ----------------------------------------------------------------

    def build(self, vectors: np.ndarray, ids: list) -> None:
        """Host-corpus build: quantize on host (C++ fast path), keep the
        codes as the checkpoint shadow, ship to the mesh (host->device is
        the fast direction), then the device build."""
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        assert n == len(ids)
        self._pin_mean(vectors)
        vectors = self._centered(vectors)
        if n < self.C * 4:
            logger.info("sharded ivf build: n=%d too small for C=%d, spill only",
                        n, self.C)
            self.spill.add(vectors, ids)
            self._live.update(ids)
            return
        rqp = rsp = resid_d = resid_s_d = None
        # Row-sharded device_put needs N % P == 0: pad with drop-rows
        # (excluded from the build via n_valid).
        n_pad = -(-n // self.P) * self.P
        if self.refine:
            # One fused C++ pass: coarse codes AND residual codes (the
            # host has one core; see IVFIndex._pack).
            from ..native_lib import np_quantize_rows_int8_refine

            q, s, rq, rs = np_quantize_rows_int8_refine(vectors)
            rqp = np.zeros((n_pad, self.dim), np.int8)
            rqp[:n] = rq
            rsp = np.zeros((n_pad,), np.float32)
            rsp[:n] = rs
            resid_d = jax.device_put(jnp.asarray(rqp), self._row_sh)
            resid_s_d = jax.device_put(jnp.asarray(rsp), self._vec_sh)
        else:
            from ..native_lib import np_quantize_rows_int8

            q, s = np_quantize_rows_int8(vectors)
        qp = np.zeros((n_pad, self.dim), np.int8)
        qp[:n] = q
        sp = np.zeros((n_pad,), np.float32)
        sp[:n] = s
        vecs_q = jax.device_put(jnp.asarray(qp), self._row_sh)
        scales = jax.device_put(jnp.asarray(sp), self._vec_sh)
        self.build_device(vecs_q, scales,
                          list(ids) + [None] * (n_pad - n), n_valid=n,
                          resid=resid_d, resid_scales=resid_s_d)
        # build_device clears the shadow (device-only path); restore it,
        # padded to align with the (padded) ids table — save() maps rows
        # through rowids, which only ever reference indices < n.
        self._host_codes = qp
        self._host_scales = sp
        self._host_resid = rqp
        self._host_resid_scales = rsp

    def _pack_scatter_sharded(self):
        """Memoized cluster-sharded variant of ivf.pack_scatter_int8 (same
        body; GSPMD routes rows to their owning shard via out_shardings).
        One jit per instance so repeated builds reuse the executable."""
        fn = getattr(self, "_pack_scatter_fn", None)
        if fn is None:
            @partial(jax.jit, static_argnames=("C", "M"),
                     out_shardings=(self._c_sh, self._cm_sh, self._cm_sh))
            def fn(vecs_q, scales, dest, C, M):
                dim_ = vecs_q.shape[1]
                data = (jnp.zeros((C * M, dim_), jnp.int8)
                        .at[dest].set(vecs_q, mode="drop").reshape(C, M, dim_))
                rsc = (jnp.zeros((C * M,), jnp.float32)
                       .at[dest].set(scales, mode="drop").reshape(C, M))
                rid = (jnp.full((C * M,), -1, jnp.int32)
                       .at[dest].set(jnp.arange(vecs_q.shape[0],
                                                dtype=jnp.int32),
                                     mode="drop").reshape(C, M))
                return data, rsc, rid

            self._pack_scatter_fn = fn
        return fn

    def _pack_scatter_resid_sharded(self):
        """Residual-table twin of _pack_scatter_sharded: scatter residual
        codes/scales to the same cluster-sharded destinations."""
        fn = getattr(self, "_pack_scatter_resid_fn", None)
        if fn is None:
            @partial(jax.jit, static_argnames=("C", "M"),
                     out_shardings=(self._c_sh, self._cm_sh))
            def fn(rq, rs, dest, C, M):
                dim_ = rq.shape[1]
                resid = (jnp.zeros((C * M, dim_), jnp.int8)
                         .at[dest].set(rq, mode="drop").reshape(C, M, dim_))
                rsc = (jnp.zeros((C * M,), jnp.float32)
                       .at[dest].set(rs, mode="drop").reshape(C, M))
                return resid, rsc

            self._pack_scatter_resid_fn = fn
        return fn

    def build_device(self, vecs_q, scales, ids: list,
                     n_valid: int | None = None,
                     resid=None, resid_scales=None) -> None:
        """SPMD build from a device-resident int8 corpus: replicated-sample
        k-means, sharded blockwise assignment, ONE global scatter into the
        cluster-sharded bucket table (GSPMD all-to-all). Mirrors
        IVFIndex.build_device (index/ivf.py) per shard."""
        n, d = vecs_q.shape
        if n_valid is None:
            n_valid = n
        assert d == self.dim and n == len(ids)
        assert n_valid >= self.C * 4, f"n={n_valid} too small for C={self.C}"
        if self.mean is None:
            self._pin_mean(None)  # caller-quantized raw codes: zero mean
        self._live.update(i for i in ids[:n_valid] if i is not None)
        self._host_codes = self._host_scales = None
        self._host_resid = self._host_resid_scales = None

        TRAIN_CAP = max(self.C * 64, 65536)
        m_samp = min(n_valid, TRAIN_CAP)
        key = jax.random.PRNGKey(self.seed)
        samp_idx = jax.random.choice(key, n_valid, (m_samp,), replace=False)
        sample = jax.device_put(
            vecs_q[samp_idx].astype(jnp.float32) * scales[samp_idx, None],
            self._rep,
        )
        self.centroids = jax.device_put(
            kmeans_fit(sample, self.C, seed=self.seed), self._rep)
        del sample

        BLOCK = 1 << 20
        parts = []
        for st in range(0, n, BLOCK):
            blk = vecs_q[st : st + BLOCK].astype(jnp.bfloat16) * scales[
                st : st + BLOCK, None
            ].astype(jnp.bfloat16)
            parts.append(kmeans_assign(blk, self.centroids))
        assign = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        if n_valid < n:
            assign = jnp.where(jnp.arange(n) < n_valid, assign, self.C)

        counts = jnp.zeros((self.C,), jnp.int32).at[assign].add(1, mode="drop")
        counts_h = np.asarray(counts)
        M = int(max(8, self.bucket_factor * max(1, counts_h.mean())))
        M = -(-M // 1024) * 1024  # buckets in whole 1024-row units
        C = self.C

        dest, order = bucket_pack_dest(assign, counts, C, M)
        self.data, self.rscales, self._rowids_dev = self._pack_scatter_sharded()(
            vecs_q, scales, dest, C, M)
        if self.refine:
            if resid is None:
                # No f32 source for residuals (device-only corpus): zero
                # residual table = plain-int8 rerank, never wrong.
                logger.info("sharded ivf build: refine on but no residual "
                            "source; zero residual table")
                resid = jax.device_put(
                    jnp.zeros_like(vecs_q), self._row_sh)
                resid_scales = jax.device_put(
                    jnp.zeros((vecs_q.shape[0],), jnp.float32), self._vec_sh)
            self.resid, self.resid_scales = self._pack_scatter_resid_sharded()(
                resid, resid_scales, dest, C, M)
        else:
            self.resid = self.resid_scales = None
        self.sizes = jax.device_put(
            jnp.minimum(counts, M).astype(jnp.int32), self._c1_sh)
        self.rowids = None
        self.ids = list(ids)
        self._ids_nulled = False
        self._base_dirty = True
        self._search_cache = {}

        # Bucket-overflow rows -> the sharded spill (positions derivable
        # from counts on host; codes gathered on device, landed in the
        # spill via its host add — the overflow set is small by design).
        starts_h = np.concatenate([[0], np.cumsum(counts_h)[:-1]])
        over = np.nonzero(counts_h > M)[0]
        if len(over):
            sel = np.concatenate(
                [np.arange(starts_h[c] + M, starts_h[c] + counts_h[c])
                 for c in over]
            ).astype(np.int32)
            spill_rows = np.asarray(jnp.take(order, jnp.asarray(sel)))
            ids_arr = np.asarray(ids, dtype=object)
            sids = ids_arr[spill_rows]
            live = np.asarray([s is not None for s in sids], bool)
            if live.any():
                live_rows = spill_rows[live]
                logger.info("sharded ivf build: %d overflow rows -> spill",
                            len(live_rows))
                sel_dev = jnp.asarray(live_rows.astype(np.int32))
                codes = np.asarray(jnp.take(vecs_q, sel_dev, axis=0))
                sscales = np.asarray(jnp.take(scales, sel_dev))
                vecs = codes.astype(np.float32) * sscales[:, None]
                self.spill.add(vecs, sids[live].tolist())
                # Capacity-aware fold (parity with IVFIndex.build_device):
                # overflow rows' first-choice buckets are full by
                # construction; place them in their next-nearest cluster
                # with free slots instead of leaving an exact-scanned
                # spill every query must pay for.
                folded = self.fold_spill()
                logger.info(
                    "sharded ivf build: folded %d/%d overflow rows into "
                    "alternate buckets (%d remain spilled)",
                    folded, len(live_rows), self.spill.count)

    def _rowids_host(self) -> np.ndarray | None:
        if self.rowids is None and self._rowids_dev is not None:
            self.rowids = np.asarray(self._rowids_dev).astype(np.int64)
        return self.rowids

    # -- mutation -------------------------------------------------------------

    def add(self, vectors: np.ndarray, ids: list) -> None:
        """Streaming ingest -> sharded spill; rebuild() folds it in.

        Re-adding a deleted id un-deletes it (stale cluster-table copies
        get their id entry nulled so they cannot resurrect); ids already
        live are idempotent no-ops (mirrors IVFIndex.add)."""
        vectors = np.asarray(vectors, np.float32)
        self._pin_mean(vectors)
        vectors = self._centered(vectors)
        readd = self._deleted.intersection(ids)
        if readd:
            for i, sid in enumerate(self.ids):
                if sid in readd:
                    self.ids[i] = None
                    self._ids_nulled = True
            self._deleted -= readd
            self._base_dirty = True
        if any(sid in self._live for sid in ids):
            fresh = [i for i, sid in enumerate(ids) if sid not in self._live]
            if not fresh:
                return
            vectors = vectors[fresh]
            ids = [ids[i] for i in fresh]
        self.spill.add(vectors, ids)
        self._live.update(ids)

    def delete(self, ids: list) -> int:
        if isinstance(ids, str):
            ids = [ids]  # a bare string would iterate characters and no-op
        # `_live` is exactly (table ids ∪ spill ids) − deleted (see
        # IVFIndex.delete) — O(batch), no O(corpus) scan over self.ids.
        removed = 0
        for sid in ids:
            if sid in self._live:
                self._deleted.add(sid)
                self._live.discard(sid)
                removed += 1
        self.spill.delete(list(ids))
        return removed

    def delete_all(self) -> None:
        self.centroids = self.data = self.rscales = self.sizes = None
        self.mean = None  # re-pinned at the next ingestion
        self.resid = self.resid_scales = None
        self._host_resid = self._host_resid_scales = None
        self._rowids_dev = None
        self.rowids = None
        self.ids = []
        self._ids_nulled = False
        self._deleted.clear()
        self._live.clear()
        self.spill.delete_all()
        self._host_codes = self._host_scales = None
        self._base_dirty = True
        self._search_cache = {}

    def fold_spill(self) -> int:
        """Stream spill rows into the existing cluster shards in place
        (assign on current centroids — nearest cluster with free capacity
        among each row's top choices — one donated SPMD scatter; GSPMD
        routes rows to their owning shard): O(spill) maintenance vs
        rebuild()'s O(corpus). Rows that fit nowhere stay spilled.
        Mirrors IVFIndex.fold_spill for the mesh tier."""
        if self.data is None or self.centroids is None or not self.spill.count:
            return 0
        C, M, D = self.data.shape
        rows = sorted(self.spill.ids.items())
        if self._deleted:
            rows = [(g, s) for g, s in rows if s not in self._deleted]
        if not rows:
            self.spill.delete_all()
            return 0
        ssel = np.asarray([g for g, _ in rows])
        sids_sel = np.asarray([s for _, s in rows], dtype=object)
        n = len(ssel)
        PAD = 1 << 12
        n_pad = max(PAD, -(-n // PAD) * PAD)
        psel = np.full((n_pad,), self.spill.P * self.spill.cap, np.int64)
        psel[:n] = ssel
        psel_d = jnp.asarray(psel)
        codes = jnp.take(self.spill.buf, psel_d, axis=0, mode="fill",
                         fill_value=0)
        scales = jnp.take(self.spill.scales, psel_d, mode="fill",
                          fill_value=0.0)
        # Capacity-aware assignment (shared with IVFIndex.fold_spill): a
        # row whose nearest bucket is full takes its next-nearest cluster
        # with free slots among its top-FOLD_CHOICES.
        choice = _topk_clusters(codes, scales, self.centroids, n,
                                min(IVFIndex.FOLD_CHOICES, C))
        a_final, slot_final, sizes_fill = _capacity_fill(
            choice, np.asarray(self.sizes), M)
        ok = a_final >= 0
        dest = np.full((n_pad,), C * M, np.int64)
        dest[np.nonzero(ok)[0]] = a_final[ok] * M + slot_final[ok]
        n_fold = int(ok.sum())
        if n_fold == 0:
            return 0
        base = len(self.ids)
        rid_new = np.full((n_pad,), -1, np.int64)
        rid_new[:n] = base + np.arange(n)

        @partial(jax.jit, donate_argnums=(0, 1, 2),
                 out_shardings=(self._c_sh, self._cm_sh, self._cm_sh))
        def _fold(data, rsc, rid, codes, scales, dest, rid_new):
            D_ = codes.shape[1]
            C_, M_, _ = data.shape
            data = data.reshape(C_ * M_, D_).at[dest].set(
                codes, mode="drop").reshape(C_, M_, D_)
            rsc = rsc.reshape(C_ * M_).at[dest].set(
                scales, mode="drop").reshape(C_, M_)
            rid = rid.reshape(C_ * M_).at[dest].set(
                rid_new.astype(jnp.int32), mode="drop").reshape(C_, M_)
            return data, rsc, rid

        self.data, self.rscales, self._rowids_dev = _fold(
            self.data, self.rscales, self._rowids_dev, codes, scales,
            jnp.asarray(dest), jnp.asarray(rid_new))
        self.rowids = None
        self.sizes = jax.device_put(
            jnp.asarray(sizes_fill.astype(np.int32)), self._c1_sh)
        folded_mask = ok
        new_ids = np.full((n,), None, dtype=object)
        new_ids[folded_mask] = sids_sel[folded_mask]
        # Extend the ids-aligned host shadow from the spill's shadow (rows
        # came through the host), keeping checkpoints zero-device-fetch.
        if self._host_codes is not None and self.spill._sh_scales is not None:
            if len(self._host_codes) == base:
                self._host_codes = np.concatenate(
                    [self._host_codes, self.spill._sh_rows[ssel]])
                self._host_scales = np.concatenate(
                    [self._host_scales, self.spill._sh_scales[ssel]])
                if self._host_resid is not None:
                    # Folded spill rows carry no residuals (they bypassed
                    # the host refine pass): zero-extend the shadow so it
                    # stays row-aligned for checkpoints.
                    self._host_resid = np.concatenate(
                        [self._host_resid,
                         np.zeros((n, self.dim), np.int8)])
                    self._host_resid_scales = np.concatenate(
                        [self._host_resid_scales, np.zeros((n,), np.float32)])
            else:  # alignment lost (shouldn't happen) — degrade gracefully
                self._host_codes = self._host_scales = None
                self._host_resid = self._host_resid_scales = None
        else:
            self._host_codes = self._host_scales = None
            self._host_resid = self._host_resid_scales = None
        self.ids.extend(new_ids.tolist())
        # Re-add leftovers to a fresh spill via the host shadow (sharded
        # spill rows always came through the host).
        left_ids = sids_sel[~folded_mask].tolist()
        left_rows = (self.spill.rows_f32(ssel[~folded_mask].tolist())
                     if left_ids else None)
        self.spill.delete_all()
        if left_ids:
            self.spill.add(left_rows, left_ids)
        self._base_dirty = True
        return n_fold

    def rebuild(self) -> None:
        """Fold spill + drop tombstones, retraining on the mesh. Gathers
        live rows into a row-sharded corpus (host supplies selection
        indices only) and re-runs the device build."""
        live_total = len(self._live)
        if live_total < self.C * 4:
            return  # spill-only regime; nothing to fold
        PAD = 1 << 16

        def _pad_to(sel, oob):
            tgt = max(PAD, -(-max(len(sel), 1) // PAD) * PAD)
            out = np.full((tgt,), oob, np.int64)
            out[: len(sel)] = sel
            return out

        parts = []
        if self.data is not None:
            rowids = self._rowids_host()
            sizes = np.asarray(self.sizes)
            M = rowids.shape[1]
            valid = (np.arange(M)[None, :] < sizes[:, None]) & (rowids >= 0)
            ids_arr = np.asarray(self.ids, dtype=object)
            if self._deleted or self._ids_nulled:
                sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
                if self._ids_nulled:
                    valid &= np.not_equal(sids, None)
                if self._deleted:
                    valid &= ~np.isin(sids.astype(str), sorted(self._deleted))
            sel = np.nonzero(valid.reshape(-1))[0]
            cl_ids = ids_arr[rowids[valid]].tolist()
            flat = self.data.reshape(-1, self.dim)
            psel = jnp.asarray(_pad_to(sel, flat.shape[0]))
            # Residual rows follow their base rows through the rebuild
            # (same gather indices; spill rows below carry zero residuals
            # until their next host ingest).
            part_r = part_rs = None
            if self.refine and self.resid is not None:
                part_r = jnp.take(self.resid.reshape(-1, self.dim), psel,
                                  axis=0, mode="fill", fill_value=0)
                part_rs = jnp.take(self.resid_scales.reshape(-1), psel,
                                   mode="fill", fill_value=0.0)
            parts.append((
                jnp.take(flat, psel, axis=0, mode="fill", fill_value=0),
                jnp.take(self.rscales.reshape(-1), psel, mode="fill",
                         fill_value=0.0),
                cl_ids, len(sel), part_r, part_rs,
            ))
            # Free the bucket table the moment its rows are gathered
            # (async-safe): holding it through the landing loop puts table
            # + gathered part + compacted corpus on-chip at once — over
            # budget at the tier's design scale.
            del flat
            self.data = self.rscales = self.sizes = None
            self.resid = self.resid_scales = None
            self._rowids_dev = None
            self.rowids = None
        if self.spill.count:
            rows = sorted(self.spill.ids.items())
            sel = np.asarray([g for g, _ in rows])
            sp_ids = [s for _, s in rows]
            psel = jnp.asarray(_pad_to(sel, self.spill.P * self.spill.cap))
            parts.append((
                jnp.take(self.spill.buf, psel, axis=0, mode="fill",
                         fill_value=0),
                jnp.take(self.spill.scales, psel, mode="fill", fill_value=0.0),
                sp_ids, len(sel), None, None,
            ))
        n_valid = sum(p[3] for p in parts)
        T = max(PAD, -(-n_valid // PAD) * PAD)

        # Keep the compacted corpus ROW-SHARDED while scattering into it:
        # eager scatters would pick replicated layouts and materialize the
        # whole corpus per device at the 100M tier.
        @partial(jax.jit, donate_argnums=(0, 1),
                 out_shardings=(self._row_sh, self._vec_sh))
        def _land(codes, scales, part_c, part_s, idx):
            return (codes.at[idx].set(part_c, mode="drop"),
                    scales.at[idx].set(part_s, mode="drop"))

        codes = jax.device_put(jnp.zeros((T, self.dim), jnp.int8), self._row_sh)
        scales = jax.device_put(jnp.zeros((T,), jnp.float32), self._vec_sh)
        r_codes = r_scales = None
        if self.refine:
            r_codes = jax.device_put(jnp.zeros((T, self.dim), jnp.int8),
                                     self._row_sh)
            r_scales = jax.device_put(jnp.zeros((T,), jnp.float32),
                                      self._vec_sh)
        ids_all: list = []
        base = 0
        for pi in range(len(parts)):
            pc, ps, pids, nreal, pr, prs = parts[pi]
            parts[pi] = None  # release the gathered part once landed
            idx = jnp.asarray(_pad_to(base + np.arange(nreal, dtype=np.int64),
                                      T)[: pc.shape[0]])
            codes, scales = _land(codes, scales, pc, ps, idx)
            if self.refine and pr is not None:
                r_codes, r_scales = _land(r_codes, r_scales, pr, prs, idx)
            ids_all.extend(pids)
            base += nreal
            del pc, ps, pr, prs
        ids_all.extend([None] * (T - n_valid))
        del parts
        self.data = self.rscales = self.sizes = None
        self.resid = self.resid_scales = None
        self._rowids_dev = None
        self.rowids = None
        self.spill.delete_all()
        self._deleted.clear()
        self._live.clear()
        self.ids = []
        self.build_device(codes, scales, ids_all, n_valid=n_valid,
                          resid=r_codes, resid_scales=r_scales)

    # -- search ---------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple]]:
        out = self._search_once(queries, k)
        # The over-fetch is hard-capped at kk <= 512,
        # so deletes adversarially concentrated in one topic can crowd out
        # every live candidate below the store's 25% churn-rebuild trigger.
        # Shortfall => ONE exact pass with kk widened past the dead count
        # (bounded, no retrain — a rebuild here would stall this query for
        # minutes at the 100M design scale) and flag maintenance_needed so
        # the store schedules the rebuild on the worker.
        if self._deleted:
            expect = min(k, self.count)
            if any(len(r) < expect for r in out):
                logger.warning(
                    "sharded ivf shortfall under %d tombstones; exact "
                    "fallback (maintenance flagged)", len(self._deleted))
                out = self._search_exact(queries, k)
                self.maintenance_needed = True
        return out

    def _search_exact(self, queries: np.ndarray, k: int) -> list[list[tuple]]:
        """Exact scan over table + spill with the over-fetch widened past
        every tombstone — correct under any delete pattern, one dispatch,
        never retrains. kk rounds up to a power of two so churn doesn't
        compile a fresh executable per dead-count."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        Q = queries.shape[0]
        merged: list[dict] = [dict() for _ in range(Q)]
        off = (queries @ self.mean
               if self.mean is not None and self.mean.any() else None)
        if self.data is not None:
            total = int(np.asarray(self.sizes).sum())
            kk = min(k + len(self._deleted), total)
            if kk > 0:
                kk = min(1 << (kk - 1).bit_length(), total)
                M = self.data.shape[1]
                fn = self._exact_cache.get(kk)
                if fn is None:
                    fn = make_exact_search_fn(self.mesh, self.axis, self.Cp,
                                              M, kk)
                    self._exact_cache[kk] = fn
                vals, gidx = fn(self.data, self.rscales, self.sizes,
                                jnp.asarray(queries))
                orig = jnp.take(self._rowids_dev.reshape(-1), gidx)
                from ..ops.host import fetch

                vals, orig = fetch(vals, orig)
                for qi in range(Q):
                    for v, r in zip(vals[qi], orig[qi]):
                        if v <= -1e29 or r < 0:
                            continue
                        sid = self.ids[r]
                        if sid is None or sid in self._deleted:
                            continue
                        merged[qi][sid] = float(v)
        if self.spill.count:
            ksp = min(k + len(self._deleted), self.spill.count)
            for qi, hits in enumerate(self.spill.search(queries, ksp)):
                for sid, v in hits:
                    if sid not in self._deleted:
                        merged[qi][sid] = v
        return _top_with_offset(merged, off, k)

    def _search_once(self, queries: np.ndarray, k: int) -> list[list[tuple]]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        Q = queries.shape[0]
        merged: list[dict] = [dict() for _ in range(Q)]
        # Centered codes (table AND spill): restore true cosines with the
        # query-constant q.mean after the merge (rank-neutral per query).
        off = (queries @ self.mean
               if self.mean is not None and self.mean.any() else None)
        if self.data is not None:
            total = int(np.asarray(self.sizes).sum())
            kk = min(k + len(self._deleted), total, 512)
            if self.rerank:
                # Wider candidate bank for the per-shard residual rerank
                # (the refined scores ride the existing kk-wide merge, so
                # depth costs only the [Q, kk, D] gather per shard).
                kk = min(max(kk, self.rerank), total, 512)
            if kk > 0:
                M = self.data.shape[1]
                # Keyed by (kk, nprobe): recall-target calibration searches
                # once at nprobe=C, and a kk-only key would serve that
                # all-probe executable a stale routing width.
                use_refine = self.refine and self.resid is not None
                fn = self._search_cache.get((kk, self.nprobe, use_refine))
                if fn is None:
                    fn = make_ivf_search_fn(
                        self.mesh, self.axis, self.Cp, M, self.nprobe, kk,
                        refine=use_refine)
                    self._search_cache[(kk, self.nprobe, use_refine)] = fn
                # The margin rides in as a dynamic scalar (4.0 = keep-all
                # sentinel): retuning prune_margin reuses the executable.
                margin = jnp.float32(4.0 if self.prune_margin is None
                                     else self.prune_margin)
                if use_refine:
                    vals, gidx = fn(self.centroids, self.data, self.rscales,
                                    self.sizes, self.resid, self.resid_scales,
                                    jnp.asarray(queries), margin)
                else:
                    vals, gidx = fn(self.centroids, self.data, self.rscales,
                                    self.sizes, jnp.asarray(queries), margin)
                # Map winners to original rows ON DEVICE: a [Q, kk] gather
                # instead of fetching the whole rowid table.
                orig = jnp.take(self._rowids_dev.reshape(-1), gidx)
                from ..ops.host import fetch

                vals, orig = fetch(vals, orig)
                for qi in range(Q):
                    for v, r in zip(vals[qi], orig[qi]):
                        if v <= -1e29 or r < 0:
                            continue
                        sid = self.ids[r]
                        if sid is None or sid in self._deleted:
                            continue
                        merged[qi][sid] = float(v)
        if self.spill.count:
            for qi, hits in enumerate(
                    self.spill.search(queries, min(k, self.spill.count))):
                for sid, v in hits:
                    if sid not in self._deleted:
                        merged[qi][sid] = v
        return _top_with_offset(merged, off, k)

    def calibrate_margin(self, queries: np.ndarray | None = None,
                         k: int = 10, target_overlap: float = 0.97,
                         margins=None, n_queries: int = 64,
                         seed: int = 0,
                         target_metric: str = "overlap") -> float | None:
        """Auto-tune prune_margin to a recall target (the margin is a
        dynamic scalar in the SPMD executable, so the sweep compiles once
        per batch shape); see ivf.calibrate_prune_margin."""
        from .ivf import calibrate_prune_margin

        return calibrate_prune_margin(
            self, queries=queries, k=k, target_overlap=target_overlap,
            margins=margins, n_queries=n_queries, seed=seed,
            target_metric=target_metric)

    def calibrate_operating_point(self, queries: np.ndarray | None = None,
                                  k: int = 10, target_recall: float = 0.95,
                                  nprobes=None, n_queries: int = 64,
                                  seed: int = 0, margins=None) -> dict | None:
        """Jointly pick (nprobe, prune_margin) against a recall floor; see
        ivf.calibrate_operating_point. Each ladder nprobe is one SPMD
        executable (nprobe is static in the routing mask), so the doubling
        ladder costs O(log C) compiles, amortized by the compile cache."""
        from .ivf import calibrate_operating_point

        return calibrate_operating_point(
            self, queries=queries, k=k, target_recall=target_recall,
            nprobes=nprobes, n_queries=n_queries, seed=seed, margins=margins)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """Same layout as IVFIndex v2: immutable base (written when dirty,
        from the host code shadow when the corpus came through the host;
        device-built bases are fetched once, compacted on device first) +
        the spill's own incremental segment log + deleted ids."""
        import json as _json
        import os as _os

        _os.makedirs(_os.path.dirname(path) or ".", exist_ok=True)
        if self._base_dirty or path != self._ckpt_path or not _os.path.exists(
                path + ".npz"):
            arrs: dict[str, np.ndarray] = {
                "centroids": (np.asarray(self.centroids)
                              if self.centroids is not None
                              else np.zeros((0, self.dim), np.float32)),
            }
            if self.data is not None:
                rowids = self._rowids_host()
                sizes = np.asarray(self.sizes)
                M = rowids.shape[1]
                valid = (np.arange(M)[None, :] < sizes[:, None]) & (rowids >= 0)
                if self._ids_nulled:
                    ids_arr = np.asarray(self.ids, dtype=object)
                    sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
                    valid &= np.not_equal(sids, None)
                rid_sel = rowids[valid]
                arrs["cluster_assign"] = np.nonzero(valid)[0].astype(np.int32)
                arrs["cluster_ids"] = np.asarray(
                    np.asarray(self.ids, dtype=object)[rid_sel].tolist())
                if self._host_codes is not None:
                    arrs["cluster_codes"] = self._host_codes[rid_sel]
                    arrs["cluster_scales"] = self._host_scales[rid_sel]
                else:
                    sel = jnp.asarray(np.nonzero(valid.reshape(-1))[0])
                    arrs["cluster_codes"] = np.asarray(
                        jnp.take(self.data.reshape(-1, self.dim), sel, axis=0))
                    arrs["cluster_scales"] = np.asarray(
                        jnp.take(self.rscales.reshape(-1), sel))
                if self.refine:
                    # Residuals follow codes through checkpoints (same
                    # contract as IVFIndex): host shadow when the corpus
                    # came through the host, slot-order device gather
                    # otherwise.
                    if (self._host_resid is not None
                            and len(self._host_resid) > rid_sel.max(initial=-1)):
                        arrs["cluster_resid"] = self._host_resid[rid_sel]
                        arrs["cluster_resid_scales"] = (
                            self._host_resid_scales[rid_sel])
                    elif self.resid is not None:
                        sel = jnp.asarray(np.nonzero(valid.reshape(-1))[0])
                        arrs["cluster_resid"] = np.asarray(jnp.take(
                            self.resid.reshape(-1, self.dim), sel, axis=0))
                        arrs["cluster_resid_scales"] = np.asarray(
                            jnp.take(self.resid_scales.reshape(-1), sel))
            else:
                arrs["cluster_assign"] = np.zeros((0,), np.int32)
                arrs["cluster_ids"] = np.zeros((0,), np.str_)
                arrs["cluster_codes"] = np.zeros((0, self.dim), np.int8)
                arrs["cluster_scales"] = np.zeros((0,), np.float32)
            np.savez(path + ".npz", **arrs)
            self._base_dirty = False
            self._ckpt_path = path
        meta = {
            "format": 2,
            "kind": "sharded_ivf",
            "dim": self.dim,
            "n_clusters": self.C,
            "nprobe": self.nprobe,
            "bucket_factor": self.bucket_factor,
            "dtype": self.dtype,
            "refine": self.refine,
            "rerank": self.rerank,
            "deleted": sorted(str(s) for s in self._deleted),
        }
        if self.mean is not None:
            meta["mean"] = [float(x) for x in self.mean]
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            _json.dump(meta, fh)
        _os.replace(tmp, path + ".meta.json")
        self.spill.save(path + ".spill")

    def restore(self, path: str) -> int:
        """Load a checkpoint into this (fresh) index: base codes are
        re-shipped to the mesh via the host->device fast path and rebuilt
        into buckets with the SAVED centroids (no k-means rerun); spill
        segments replay through the sharded spill."""
        import json as _json
        import os as _os

        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = _json.load(fh)
        deleted = set(meta.get("deleted", []))
        if "mean" in meta:
            # Pin BEFORE any codes land: table and spill rows on disk are
            # stored centered against this mean.
            self.mean = np.asarray(meta["mean"], np.float32)
        arrs = np.load(path + ".npz")
        restored = 0
        cids = arrs["cluster_ids"]
        if len(arrs["centroids"]) and len(cids):
            keep = (~np.isin(cids.astype(str), sorted(deleted))
                    if deleted else slice(None))
            codes = arrs["cluster_codes"][keep]
            scales = arrs["cluster_scales"][keep]
            kept_ids = [str(s) for s in cids[keep]]
            r_codes = r_scales = None
            if self.refine and "cluster_resid" in arrs:
                r_codes = arrs["cluster_resid"][keep]
                r_scales = arrs["cluster_resid_scales"][keep]
            # Re-pack with the saved centroids: call build_device but skip
            # retraining by seeding centroids first.
            self.centroids = jax.device_put(
                jnp.asarray(arrs["centroids"]), self._rep)
            self._pack_with_centroids(codes, scales, kept_ids,
                                      resid=r_codes, resid_scales=r_scales)
            self._host_codes = codes
            self._host_scales = scales
            self._host_resid = r_codes
            self._host_resid_scales = r_scales
            restored += len(kept_ids)
        if _os.path.exists(path + ".spill.meta.json"):
            n = self.spill.restore(path + ".spill")
            self._live.update(self.spill._id_to_row)
            restored += n
        if restored and self.mean is None:
            # Pre-centering checkpoint (no "mean" in meta): its codes are
            # RAW. Pin zero-mean NOW — otherwise the next add() would pin
            # a fresh mean and center new spill rows against a table of
            # raw codes, skewing every merged score by q.mean.
            self.mean = np.zeros((self.dim,), np.float32)
        self._ckpt_path = path
        # When deletes were filtered, the on-disk base still contains the
        # dead rows while _deleted is left empty — rewrite the compacted
        # base at the next save or the rows resurrect on the reload after.
        self._base_dirty = bool(deleted)
        return restored

    def _pack_with_centroids(self, codes: np.ndarray, scales: np.ndarray,
                             ids: list, resid: np.ndarray | None = None,
                             resid_scales: np.ndarray | None = None) -> None:
        """Assign + scatter host rows against existing centroids (restore
        path — no k-means)."""
        n = codes.shape[0]
        n_pad = -(-max(n, 1) // self.P) * self.P  # row sharding divisibility
        cp = np.zeros((n_pad, self.dim), np.int8)
        cp[:n] = codes
        sp = np.zeros((n_pad,), np.float32)
        sp[:n] = scales
        vecs_q = jax.device_put(jnp.asarray(cp), self._row_sh)
        dscales = jax.device_put(jnp.asarray(sp), self._vec_sh)
        BLOCK = 1 << 20
        parts = []
        for st in range(0, n_pad, BLOCK):
            blk = vecs_q[st : st + BLOCK].astype(jnp.bfloat16) * dscales[
                st : st + BLOCK, None
            ].astype(jnp.bfloat16)
            parts.append(kmeans_assign(blk, self.centroids))
        assign = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        if n < n_pad:
            assign = jnp.where(jnp.arange(n_pad) < n, assign, self.C)
        counts = jnp.zeros((self.C,), jnp.int32).at[assign].add(1, mode="drop")
        counts_h = np.asarray(counts)
        M = int(max(8, self.bucket_factor * max(1, counts_h.mean())))
        M = max(M, int(counts_h.max()))
        M = -(-M // 1024) * 1024
        C = self.C
        dest, _ = bucket_pack_dest(assign, counts, C, M)
        self.data, self.rscales, self._rowids_dev = self._pack_scatter_sharded()(
            vecs_q, dscales, dest, C, M)
        if self.refine:
            if resid is not None:
                rp = np.zeros((n_pad, self.dim), np.int8)
                rp[:n] = resid
                rsp = np.zeros((n_pad,), np.float32)
                rsp[:n] = resid_scales
                r_dev = jax.device_put(jnp.asarray(rp), self._row_sh)
                rs_dev = jax.device_put(jnp.asarray(rsp), self._vec_sh)
            else:  # pre-refine checkpoint: zero residuals (plain rerank)
                r_dev = jax.device_put(jnp.zeros_like(vecs_q), self._row_sh)
                rs_dev = jax.device_put(jnp.zeros((n_pad,), jnp.float32),
                                        self._vec_sh)
            self.resid, self.resid_scales = self._pack_scatter_resid_sharded()(
                r_dev, rs_dev, dest, C, M)
        self.sizes = jax.device_put(
            jnp.minimum(counts, M).astype(jnp.int32), self._c1_sh)
        self.rowids = None
        self.ids = list(ids)
        self._ids_nulled = False
        self._live.update(ids)
        self._search_cache = {}

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        import os as _os

        from .flat import FlatIndex

        FlatIndex.remove_checkpoint(path + ".spill")
        for suffix in (".npz", ".meta.json"):
            try:
                _os.remove(path + suffix)
            except FileNotFoundError:
                pass
