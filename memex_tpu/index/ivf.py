"""IVFIndex — k-means partitioned index (the 10M-100M scale tier).

Expert-style routing (SURVEY.md §2.3 item 2): queries score the centroid
table, pick `nprobe` clusters, and scan only those clusters' rows. At
nprobe/C = 1/16 this cuts scanned bytes ~16x vs flat, trading exactness for
recall — the knob the reference delegates to HNSW's ef_search
(lib/libmemex/src/storage/local.rs:76) and we expose directly.

Device layout (all static shapes):
  data    [C, M, D]  — clusters padded to fixed bucket size M
  sizes   [C]        — live rows per cluster
  rowids  [C, M]     — global row -> host id table index
  centroids [C, D]

Search is fully batched on the device: gathering the probed clusters
[Q, nprobe, M, D] is memory-prohibitive, so instead we scan over nprobe
steps; each step gathers ONE cluster per query ([Q, M, D] via take) and
scores it as a batched matvec, and one top-k over all probe scores
finishes. Probe steps are bandwidth-bound by design (each row is read
once per probing query).

Overflow: vectors arriving after build() (streaming ingest) go to a side
FlatIndex scanned exactly; `rebuild()` folds them in. Cluster-bucket
overflow at build time also spills there, so results are exact w.r.t. the
probed clusters + spill — recall loss comes only from unprobed clusters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..log import get_logger
from ..ops.quant import prune_probes
from ..ops.topk import blockwise_topk
from .flat import FlatIndex

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# k-means (on-device Lloyd iterations, jitted once per (C, D))
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_clusters", "iters"))
def kmeans_fit(vectors: jnp.ndarray, n_clusters: int, iters: int = 10, seed: int = 0):
    """Spherical k-means on unit vectors: assign by max inner product,
    update = renormalized mean. Returns [C, D] unit centroids."""
    n, d = vectors.shape
    key = jax.random.PRNGKey(seed)
    init_idx = jax.random.choice(key, n, (n_clusters,), replace=n < n_clusters)
    centroids = vectors[init_idx]

    def step(centroids, _):
        scores = jnp.einsum(
            "nd,cd->nc",
            vectors.astype(jnp.bfloat16),
            centroids.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        assign = jnp.argmax(scores, axis=1)
        onehot = jax.nn.one_hot(assign, n_clusters, dtype=jnp.bfloat16)  # [N, C]
        sums = jnp.einsum(
            "nc,nd->cd", onehot, vectors.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        counts = jnp.sum(onehot.astype(jnp.float32), axis=0)[:, None]
        means = sums / jnp.maximum(counts, 1.0)
        # Empty clusters keep their old centroid.
        means = jnp.where(counts > 0, means, centroids)
        norms = jnp.linalg.norm(means, axis=1, keepdims=True)
        return means / jnp.maximum(norms, 1e-12), None

    centroids, _ = jax.lax.scan(step, centroids, None, length=iters)
    return centroids


@jax.jit
def kmeans_assign(vectors: jnp.ndarray, centroids: jnp.ndarray) -> jnp.ndarray:
    scores = jnp.einsum(
        "nd,cd->nc",
        vectors.astype(jnp.bfloat16),
        centroids.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return jnp.argmax(scores, axis=1)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("nprobe", "k"))
def _ivf_search(centroids, data, rscales, sizes, queries, margin,
                nprobe: int, k: int):
    """(centroids [C,D], data [C,M,D] (f32/bf16/int8), rscales [C,M],
    sizes [C], queries [Q,D], margin [] f32) -> (vals [Q,k], cluster
    [Q,k], slot [Q,k]).

    Each query scans its own probes ([Q, M, D] gathers, one probe per scan
    step). `margin` is the dynamic prune scalar: probes whose centroid
    score trails the query's best by more than it are skipped (their
    scores stay masked), with ops/quant.prune_probes' rule; 4.0 keeps
    all. Storage dtype cuts scanned bytes 2x/4x like the flat tiers."""
    Q, D = queries.shape
    C, M, _ = data.shape
    # f32 routing at HIGHEST precision: the [Q, C] centroid product is
    # tiny, and a reduced-precision one would misroute near-tied probes.
    qc = jnp.einsum("qd,cd->qc", queries, centroids,
                    precision=jax.lax.Precision.HIGHEST)
    top_vals, probes = jax.lax.top_k(qc, nprobe)  # [Q, nprobe]
    live = prune_probes(top_vals, probes, margin, C) < C

    exact = data.dtype == jnp.float32

    def step(_, p):
        cids = probes[:, p]                    # [Q]
        cluster = jnp.take(data, cids, axis=0)  # [Q, M, D]
        csize = jnp.where(live[:, p], jnp.take(sizes, cids), 0)  # [Q]
        if exact:
            # f32 in-cluster scoring at HIGHEST precision: this tier's
            # contract is exact scores, and a default-precision f32
            # product may run in TF32 on a GPU.
            scores = jnp.einsum("qmd,qd->qm", cluster, queries,
                                precision=jax.lax.Precision.HIGHEST)
        else:
            scores = jnp.einsum(
                "qmd,qd->qm",
                cluster.astype(jnp.bfloat16),
                queries.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ) * jnp.take(rscales, cids, axis=0)
        slot = jax.lax.broadcasted_iota(jnp.int32, (Q, M), 1)
        return None, jnp.where(slot < csize[:, None], scores, -1e30)

    # Accumulate ALL probe scores ([nprobe, Q, M]), then ONE top-k: a
    # running per-step merge would sort nprobe times.
    _, all_scores = jax.lax.scan(step, None, jnp.arange(nprobe))
    flat = jnp.transpose(all_scores, (1, 0, 2)).reshape(Q, nprobe * M)
    vals, flat_idx = blockwise_topk(flat, k)
    p_sel = flat_idx // M
    sl = flat_idx % M
    cl = jnp.take_along_axis(probes, p_sel, axis=1)
    return vals, cl, sl


def _topk_clusters(codes, scales, centroids, n, R, blk=1 << 18, mean=None):
    """Top-R candidate clusters per (padded) quantized row; [n, R] int32
    on host. One bf16 matmul block at a time; the fetch is tiny.

    `mean`: when codes are mean-centered residuals, row-to-cluster scores
    need + mean.centroids^T (a [C] vector) — unlike the query-side routing
    shift this varies ACROSS clusters, so it does change the argmax. The
    correction is exact whichever space the centroids live in (raw or
    residual): the two differ per row only by a row-constant v.mean."""
    cent_t = centroids.astype(jnp.bfloat16).T
    moff = (jnp.asarray(mean, jnp.bfloat16) @ cent_t
            if mean is not None and np.asarray(mean).any() else None)
    tops = []
    for s in range(0, codes.shape[0], blk):
        x = (codes[s : s + blk].astype(jnp.bfloat16)
             * scales[s : s + blk, None].astype(jnp.bfloat16))
        sc = x @ cent_t
        if moff is not None:
            sc = sc + moff[None, :]
        tops.append(jax.lax.top_k(sc, R)[1].astype(jnp.int32))
    return np.asarray(jnp.concatenate(tops) if len(tops) > 1 else tops[0])[:n]


@partial(jax.jit, static_argnames=("keep",))
def _exact_topk_rerank(data, rscales, queries, vals, cl, sl, keep: int,
                       resid=None, resid_scales=None):
    """Exact re-scoring of the coarse scan's top-kk candidates, on device:
    gather the stored rows ([Q, kk, D] — Q*kk*D bytes, negligible next to
    the scan's probed-union read) and redo the dot at HIGHEST precision
    (int8 codes dequantize exactly). The coarse scan feeds bf16 inputs,
    so top-k boundary gaps below bf16 resolution rank arbitrarily there;
    this pass restores exact order
    within the candidate set. With a refinement store (resid: [C, M, D]
    int8 codes of the quantization residual + per-row resid_scales) the
    gather also reads the residual codes and reconstructs candidates at
    ~14 effective bits, so int8 storage reranks by near-f32 scores —
    dequantizing the same coarse codes cannot recover what rounding
    destroyed (r3 verdict item 2). Sentinel candidates (vals <= -1e29:
    fewer live rows than kk) keep their sentinel so the host filter still
    drops them. Returns (vals [Q,keep], cl [Q,keep], sl [Q,keep])."""
    rows = data[cl, sl].astype(jnp.float32) * rscales[cl, sl][..., None]
    if resid is not None:
        rows = rows + (resid[cl, sl].astype(jnp.float32)
                       * resid_scales[cl, sl][..., None])
    scores = jnp.einsum("qd,qkd->qk", queries.astype(jnp.float32), rows,
                        precision=jax.lax.Precision.HIGHEST)
    scores = jnp.where(vals > -1e29, scores, vals)
    top_v, top_j = jax.lax.top_k(scores, keep)
    return (top_v, jnp.take_along_axis(cl, top_j, axis=1),
            jnp.take_along_axis(sl, top_j, axis=1))


def _capacity_fill(choice: np.ndarray, sizes: np.ndarray, M: int):
    """Greedy capacity-aware placement: round j sends each still-homeless
    row to its j-th-nearest cluster if that bucket has free slots. Rows
    whose nearest bucket has space land exactly where plain assignment
    would put them (round 0). Returns (cluster [n] with -1 for unplaced,
    slot [n], sizes_after [C])."""
    n, R = choice.shape
    C = len(sizes)
    sizes_fill = sizes.astype(np.int64).copy()
    a_final = np.full((n,), -1, np.int64)
    slot_final = np.full((n,), -1, np.int64)
    for j in range(R):
        rem = np.nonzero(a_final < 0)[0]
        if not len(rem):
            break
        cand = choice[rem, j].astype(np.int64)
        ordj = np.argsort(cand, kind="stable")
        cnt = np.bincount(cand[ordj], minlength=C)
        startsj = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        posj = np.arange(len(cand), dtype=np.int64) - startsj[cand[ordj]]
        slotj = sizes_fill[cand[ordj]] + posj
        okj = slotj < M
        rows = rem[ordj[okj]]
        a_final[rows] = cand[ordj[okj]]
        slot_final[rows] = slotj[okj]
        sizes_fill = np.minimum(
            sizes_fill + np.bincount(cand[ordj[okj]], minlength=C), M
        )
    return a_final, slot_final, sizes_fill


def bucket_pack_dest(assign, counts, C: int, M: int):
    """Per-row scatter destination into the padded [C*M] bucket layout:
    rows are stable-packed cluster-sorted; rows past a full bucket (and
    padding rows routed to pseudo-cluster C) get dest == C*M, which is out
    of bounds for the flat target — the mode='drop' scatter discards them
    (they go to the spill). Shared by the single-chip and mesh builders so
    the packing semantics cannot drift."""
    n = assign.shape[0]
    order = jnp.argsort(assign)
    sorted_assign = jnp.take(assign, order)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    pos = jnp.arange(n, dtype=jnp.int32) - jnp.take(starts, sorted_assign)
    dest_sorted = jnp.where(pos < M, sorted_assign * M + pos, C * M)
    # Per-original-row destination (scatter instead of gather: avoids
    # materializing a second full copy of the corpus). `order` rides along
    # for the callers' overflow-row derivation (cluster c's overflow sits
    # at sorted positions starts[c]+M..counts[c]).
    dest = jnp.zeros((n,), jnp.int32).at[order].set(dest_sorted)
    return dest, order


# Scatter inside ONE jit: eagerly, `.at[dest].set` would materialize the
# zeros input AND the output (2x the [C*M, D] bucket = OOM at 10M rows);
# jitted, the init and scatter share one buffer.
@partial(jax.jit, static_argnames=("C", "M"))
def pack_scatter_int8(vecs_q, scales, dest, C: int, M: int):
    dim_ = vecs_q.shape[1]
    data = (jnp.zeros((C * M, dim_), jnp.int8)
            .at[dest].set(vecs_q, mode="drop").reshape(C, M, dim_))
    rsc = (jnp.zeros((C * M,), jnp.float32)
           .at[dest].set(scales, mode="drop").reshape(C, M))
    rid = (jnp.full((C * M,), -1, jnp.int32)
           .at[dest].set(jnp.arange(vecs_q.shape[0], dtype=jnp.int32),
                         mode="drop").reshape(C, M))
    return data, rsc, rid


@partial(jax.jit, donate_argnums=(0, 1))
def _land_rows(codes, scales, part_c, part_s, idx):
    """Donated in-place landing of a (small) row block into the compacted
    corpus buffers (rebuild_device's spill part): eagerly, .at[].set would
    copy the full corpus-sized operand. OOB idx (padding) drops."""
    return (codes.at[idx].set(part_c, mode="drop"),
            scales.at[idx].set(part_s, mode="drop"))


@partial(jax.jit, donate_argnums=(0, 1, 2))
def _fold_scatter(data, rsc, rid, codes, scales, dest, rid_new):
    """In-place (donated) scatter of spill rows into bucket slots: the
    fold_spill hot op. OOB dests (full buckets / padding) drop."""
    C, M, D_ = data.shape
    data = data.reshape(C * M, D_).at[dest].set(
        codes, mode="drop").reshape(C, M, D_)
    rsc = rsc.reshape(C * M).at[dest].set(scales, mode="drop").reshape(C, M)
    rid = rid.reshape(C * M).at[dest].set(
        rid_new.astype(jnp.int32), mode="drop").reshape(C, M)
    return data, rsc, rid


@partial(jax.jit, donate_argnums=(0, 1))
def _fold_scatter_resid(resid, rsc2, rcodes, rscales, dest):
    """Refinement-table twin of _fold_scatter: residual codes follow
    their coarse codes slot-for-slot (one code space, two tables)."""
    C, M, D_ = resid.shape
    resid = resid.reshape(C * M, D_).at[dest].set(
        rcodes, mode="drop").reshape(C, M, D_)
    rsc2 = rsc2.reshape(C * M).at[dest].set(
        rscales, mode="drop").reshape(C, M)
    return resid, rsc2


class IVFIndex:
    """k-means inverted-file index with exact in-cluster scoring.

    build(vectors, ids) trains centroids and packs clusters; add() streams
    into a flat spill index; rebuild() folds spill back in.
    """

    def __init__(
        self,
        dim: int,
        n_clusters: int = 256,
        nprobe: int = 32,
        bucket_factor: float = 2.0,
        seed: int = 0,
        dtype: str = "float32",
        prune_margin: float | None = None,
        center: bool | None = None,
        rerank: int | None = None,
        scan_precision: str = "default",
        refine: bool = False,
    ):
        assert dtype in ("float32", "bfloat16", "int8"), dtype
        # Residual-refinement store (see FlatIndex.refine / native quant
        # two-stage pass): a parallel [C, M, D] int8 table of quantization
        # residuals, read ONLY by the exact-rerank gather — the coarse
        # scan's bytes/QPS are untouched; the rerank reconstructs
        # candidates at ~14 effective bits and restores near-f32 ranking
        # on corpora where the int8 tier's recall floor is quantization
        # itself (realtext tie-aware 0.744 -> the f32 bar). Costs one more
        # N*D int8 table of HBM; host-ingest only (device bulk builds have
        # no f32 source to derive residuals from).
        assert not refine or dtype == "int8", \
            "refine needs int8 storage (float tiers have no quantization residual)"
        self.refine = bool(refine)
        if self.refine and rerank is None:
            rerank = 256
        self.dim = dim
        self.C = n_clusters
        self.nprobe = min(nprobe, n_clusters)
        self.bucket_factor = bucket_factor
        self.seed = seed
        self.dtype = dtype
        # Opt-in routing prune (ops/quant.prune_probes): probes whose
        # centroid score trails the query's best by more than the margin
        # are skipped. nprobe stays the recall-side upper bound.
        self.prune_margin = prune_margin
        # Opt-in exact re-scoring depth: the scan retrieves the top-`rerank`
        # candidates instead of top-k, then _exact_topk_rerank gathers those
        # rows and redoes the dot at full precision (HIGHEST; dequantized
        # f32 for int8). The coarse scan feeds bf16 inputs, so on strongly
        # anisotropic corpora the top-k boundary gaps sit below bf16
        # resolution even after centering; the gather costs Q*rerank*D
        # bytes vs the scan's full probed read
        # (measured sim: recall@10 vs exact 0.92 -> 0.997 at pairwise
        # cos 0.9985 with rerank=50).
        self.rerank = None if rerank is None else min(int(rerank), 1024)
        # scan_precision="highest" (f32 storage only): the probe scan keeps
        # f32 inputs at HIGHEST precision, so candidates are selected by
        # EXACT scores; use for near-tie corpora where even centered bf16
        # inputs misrank the candidates themselves (rerank can only reorder
        # what the scan kept).
        assert scan_precision in ("default", "highest"), scan_precision
        # Same contract as FlatIndex: exact scan is f32-storage-only
        # (quantized tiers have no f32 rows to score exactly).
        assert scan_precision == "default" or dtype == "float32", (
            f"scan_precision='highest' requires float32 storage, got {dtype}")
        self.scan_precision = scan_precision
        self.centroids: jnp.ndarray | None = None
        self.data: jnp.ndarray | None = None          # [C, M, D] storage dtype
        self.rscales: jnp.ndarray | None = None       # [C, M] f32 (int8 mode)
        self.resid: jnp.ndarray | None = None         # [C, M, D] int8 (refine)
        self.resid_scales: jnp.ndarray | None = None  # [C, M] f32 (refine)
        self.sizes: jnp.ndarray | None = None
        self.rowids: np.ndarray | None = None  # [C, M] -> index into self.ids
        self._rowids_dev = None  # device rowid table (device-built indexes)
        self.ids: list[str] = []
        # Anisotropy-corrected int8 (see FlatIndex.center): ONE mean per
        # IVF index, pinned at the first HOST-quantized ingestion and
        # shared with the spill so fold/rebuild move codes within a single
        # code space. Device-built corpora (build_device/add_quantized)
        # pin a zero mean — caller-quantized raw codes keep today's exact
        # semantics. Query-side routing is shift-invariant (all centroid
        # scores move by the same -q.mean, so probe selection and prune
        # margins are untouched); row-side fold assignment gets the exact
        # +mean.centroids correction in _topk_clusters.
        # Centering applies to float tiers too: the scan feeds bf16
        # inputs, and concentrated corpora (real sentence
        # embeddings, pairwise cos 0.95+) put the informative score gaps
        # below bf16 resolution near 1.0; residual storage restores them.
        self.center = True if center is None else bool(center)
        self.mean: np.ndarray | None = None
        # Spill never pins its own center: the IVF pins for both. It shares
        # the rerank depth too — merged scores must come from the same
        # precision tier, or spill-resident near-ties rank arbitrarily.
        self.spill = FlatIndex(dim, dtype=dtype, center=False,
                               rerank=self.rerank,
                               scan_precision=scan_precision,
                               refine=self.refine)
        self._deleted: set[str] = set()
        self._live: set[str] = set()
        # True once add() nulled stale table id entries on a delete->re-add;
        # gates the (ids-gather) null-row exclusion in mask/save paths.
        self._ids_nulled = False
        # Checkpoint state: the cluster base is immutable between
        # (re)builds, so save() rewrites it only when dirty; streaming
        # ingest checkpoints move only the spill delta (FlatIndex segment
        # log) + the deleted-id list.
        self._base_dirty = False
        self._ckpt_path: str | None = None
        self._host_data: np.ndarray | None = None  # packed-table shadow
        self._host_scales: np.ndarray | None = None
        self._host_resid: np.ndarray | None = None  # refine-table shadow
        self._host_resid_scales: np.ndarray | None = None
        self.needs_recovery = False  # set by load() when the base was skipped
    @property
    def count(self) -> int:
        return len(self._live)

    def _pin_mean(self, vectors: np.ndarray | None) -> None:
        """Pin the shared quantization center (idempotent). Must run before
        the first code lands in either the table or the spill."""
        if self.mean is not None:
            return
        if self.center and vectors is not None and len(vectors):
            self.mean = np.asarray(vectors, np.float32).mean(axis=0)
        else:
            self.mean = np.zeros((self.dim,), np.float32)
        assert self.spill.count == 0 or not self.mean.any(), \
            "spill holds raw codes; cannot center after the fact"
        self.spill.mean = self.mean.copy()

    # -- build ---------------------------------------------------------------

    def build(self, vectors: np.ndarray, ids: list[str]) -> None:
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        assert n == len(ids)
        self._live.update(ids)
        self._pin_mean(vectors)
        if n < self.C * 4:
            logger.info("ivf build: n=%d too small for C=%d, using spill only", n, self.C)
            self.spill.add(vectors, ids)
            return
        # Train centroids on a subsample (standard practice: ~scales with C,
        # not N — a full [N, C] Lloyd assignment at 10M x 3k would be 120GB),
        # then assign all rows in HBM-bounded blocks.
        TRAIN_CAP = max(self.C * 64, 65536)
        if n > TRAIN_CAP:
            rng = np.random.default_rng(self.seed)
            sample = vectors[rng.choice(n, TRAIN_CAP, replace=False)]
        else:
            sample = vectors
        self.centroids = kmeans_fit(jnp.asarray(sample), self.C, seed=self.seed)
        assign = np.empty((n,), np.int64)
        BLOCK = 262_144
        for s in range(0, n, BLOCK):
            assign[s : s + BLOCK] = np.asarray(
                kmeans_assign(jnp.asarray(vectors[s : s + BLOCK]), self.centroids)
            )
        counts = np.bincount(assign, minlength=self.C)
        M = int(max(8, self.bucket_factor * max(1, counts.mean())))
        M = -(-M // 1024) * 1024  # buckets in whole 1024-row units
        # Vectorized packing (no per-row Python loop): stable-sort rows by
        # cluster; position-within-cluster beyond M overflows to spill.
        order = np.argsort(assign, kind="stable")
        sorted_c = assign[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(n, dtype=np.int64) - starts[sorted_c]
        in_bucket = pos < M
        data = np.zeros((self.C, M, self.dim), np.float32)
        rowids = np.full((self.C, M), -1, np.int64)
        rows_sel = order[in_bucket]
        data[sorted_c[in_bucket], pos[in_bucket]] = vectors[rows_sel]
        rowids[sorted_c[in_bucket], pos[in_bucket]] = rows_sel
        self.ids = list(ids)
        self._ids_nulled = False
        if self.mean.any():
            # Centered storage: padding rows (zeros) become -mean, which
            # corrects to a true score of exactly 0 — identical standing
            # to today's zero-padding in the in-kernel top-k.
            data -= self.mean
        self._pack(data)
        self.sizes = jnp.asarray(np.minimum(counts, M).astype(np.int32))
        self.rowids = rowids
        self._rowids_dev = None
        self._base_dirty = True
        n_spill = int(n - in_bucket.sum())
        if n_spill:
            spill_rows = order[~in_bucket]
            logger.info("ivf build: %d bucket-overflow rows -> spill", n_spill)
            self.spill.add(vectors[spill_rows], [ids[i] for i in spill_rows])

    def build_device(self, vecs_q, scales, ids: list, n_valid: int | None = None) -> None:
        """All-device build from an int8 corpus already resident on device.

        The host-side `build()` needs the f32 corpus in host RAM and ships
        [C, M, D] to the device; this path keeps everything on device —
        k-means on a
        dequantized sample, blockwise assignment, argsort packing, and
        scatter into the padded cluster bucket — and only fetches the small
        rowid table. vecs_q: [N, D] int8 (device), scales: [N] f32 (device),
        ids: host list of row ids (any hashables). Rows at index >= n_valid
        are padding (shape-bucketed callers like rebuild_device): they are
        excluded from training/packing and never land in a bucket.
        """
        assert self.dtype == "int8", "device build packs int8 storage"
        assert not self.refine, (
            "refine needs host-derived residual codes; device bulk builds "
            "receive caller-quantized int8 only (no f32 source)")
        n, d = vecs_q.shape
        if n_valid is None:
            n_valid = n
        assert d == self.dim and n == len(ids)
        assert n_valid >= self.C * 4, f"n={n_valid} too small for C={self.C}"
        if self.mean is None:
            self._pin_mean(None)  # caller-quantized raw codes: zero mean
        self._live.update(i for i in ids[:n_valid] if i is not None)

        TRAIN_CAP = max(self.C * 64, 65536)
        m_samp = min(n_valid, TRAIN_CAP)
        key = jax.random.PRNGKey(self.seed)
        samp_idx = jax.random.choice(key, n_valid, (m_samp,), replace=False)
        sample = vecs_q[samp_idx].astype(jnp.float32) * scales[samp_idx, None]
        self.centroids = kmeans_fit(sample, self.C, seed=self.seed)
        del sample

        BLOCK = 1 << 20
        parts = []
        for s in range(0, n, BLOCK):
            blk = vecs_q[s : s + BLOCK].astype(jnp.bfloat16) * scales[
                s : s + BLOCK, None
            ].astype(jnp.bfloat16)
            parts.append(kmeans_assign(blk, self.centroids))
        assign = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        if n_valid < n:
            # Padding rows sort to the tail (pseudo-cluster C) and scatter
            # out of bounds -> dropped.
            assign = jnp.where(jnp.arange(n) < n_valid, assign, self.C)

        counts = jnp.zeros((self.C,), jnp.int32).at[assign].add(1, mode="drop")
        counts_h = np.asarray(counts)
        M = int(max(8, self.bucket_factor * max(1, counts_h.mean())))
        M = -(-M // 1024) * 1024  # buckets in whole 1024-row units
        C, dim = self.C, self.dim

        dest, order = bucket_pack_dest(assign, counts, C, M)
        self.data, self.rscales, rid_cm = pack_scatter_int8(
            vecs_q, scales, dest, C, M)
        self.sizes = jnp.minimum(counts, M).astype(jnp.int32)
        # The rowid table stays ON DEVICE (84 MB int32 at 10M rows): search
        # maps winners to original rows with a tiny device gather, and host
        # save/compact paths fetch it lazily via _rowids_host().
        self.rowids = None
        self._rowids_dev = rid_cm
        self.ids = list(ids)
        self._ids_nulled = False
        self._base_dirty = True
        self._host_data = self._host_scales = None  # device-resident only

        # Spill rows: their sorted positions are derivable from counts on
        # the host (cluster c overflows positions starts[c]+M..counts[c]),
        # so no device nonzero / full-mask fetch is needed; fetch the int8
        # codes + scales (4x fewer bytes than f32) and dequantize on host.
        starts_h = np.concatenate([[0], np.cumsum(counts_h)[:-1]])
        over = np.nonzero(counts_h > M)[0]
        if len(over):
            sel = np.concatenate(
                [np.arange(starts_h[c] + M, starts_h[c] + counts_h[c]) for c in over]
            ).astype(np.int32)
            spill_rows = np.asarray(jnp.take(order, jnp.asarray(sel)))
            logger.info("ivf device build: %d bucket-overflow rows -> spill",
                        len(spill_rows))
            sel_dev = jnp.asarray(spill_rows)
            # Device-to-device: the codes never touch the host; ids mapped
            # with a vectorized object-array gather (a Python loop here ran
            # minutes at 1M overflow rows).
            spill_ids = np.asarray(ids, dtype=object)[spill_rows].tolist()
            self.spill.add_quantized(
                jnp.take(vecs_q, sel_dev, axis=0),
                jnp.take(scales, sel_dev),
                spill_ids,
            )
            # Overflow rows' FIRST-choice buckets are full by construction;
            # the capacity-aware fold places them in their next-nearest
            # cluster with free slots instead of leaving an O(corpus-scale)
            # spill that every query must exact-scan (10M @ C=4096 spilled
            # ~5% here, tripling per-query scan bytes).
            folded = self.fold_spill()
            logger.info("ivf device build: folded %d/%d overflow rows into "
                        "alternate buckets (%d remain spilled)",
                        folded, len(spill_rows), self.spill.count)

    def _rowids_host(self) -> np.ndarray | None:
        """Host rowid table; device-built indexes fetch + cache it on first
        use (save/compact paths only — search never needs it)."""
        if self.rowids is None and self._rowids_dev is not None:
            self.rowids = np.asarray(self._rowids_dev).astype(np.int64)
        return self.rowids

    def _pack(self, data: np.ndarray) -> None:
        """[C, M, D] f32 -> device arrays in the storage dtype. Keeps a host
        shadow of the packed table so save() never fetches it back through
        the slow device->host path (mirrors FlatIndex's shadow)."""
        C, M, D = data.shape
        if self.dtype == "int8":
            if self.refine:
                # One fused C++ pass over the packed table: coarse codes
                # AND residual codes (the host has one core; a separate
                # dequant+subtract+requant in numpy is ~100s at 1M rows).
                from ..native_lib import np_quantize_rows_int8_refine

                q, s, rq, rs = np_quantize_rows_int8_refine(
                    data.reshape(C * M, D))
                self.resid = jnp.asarray(rq.reshape(C, M, D))
                self.resid_scales = jnp.asarray(rs.reshape(C, M))
                self._host_resid = rq.reshape(C, M, D)
                self._host_resid_scales = rs.reshape(C, M)
            else:
                from ..native_lib import np_quantize_rows_int8

                q, s = np_quantize_rows_int8(data.reshape(C * M, D))
            self.data = jnp.asarray(q.reshape(C, M, D))
            self.rscales = jnp.asarray(s.reshape(C, M))
            self._host_data = q.reshape(C, M, D)
            self._host_scales = s.reshape(C, M)
        else:
            self.data = jnp.asarray(
                data, jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32
            )
            self.rscales = jnp.ones((C, M), jnp.float32)
            self._host_data = data.astype(np.float32)
            self._host_scales = None

    def add(self, vectors: np.ndarray, ids: list[str]) -> None:
        """Streaming ingest: spill index, folded in at next rebuild().

        Re-adding a deleted id un-deletes it: any stale cluster-table copy
        has its id entry nulled (so it can never resurrect once the id
        leaves `_deleted`) and the fresh row becomes the live one. Ids
        already live are idempotent no-ops (mirrors FlatIndex.add) — this
        is what makes SQL recovery's force re-stream safe to run over a
        partially-restored index."""
        vectors = np.asarray(vectors, np.float32)
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
        self._pin_mean(vectors)
        self.spill.add(vectors, ids)
        self._live.update(ids)

    # How many nearest clusters a spill row may fold into. Choice 1 is the
    # true assignment; when that bucket is full the row takes the nearest
    # cluster WITH free slots among its top-FOLD_CHOICES — at nprobe >= 8
    # a query near the row probes those clusters anyway, so recall impact
    # is marginal, while the alternative (exact-scanning the spill forever)
    # costs every future query O(spill) bandwidth. Bucket-overflow at
    # build time is the big case: 10M @ C=4096 spilled ~5% of the corpus
    # on cluster-size imbalance alone, tripling the per-query scan bytes.
    FOLD_CHOICES = 8

    def fold_spill(self) -> int:
        """Stream spill rows into the EXISTING partitions in place: assign
        on the current centroids (nearest cluster with free capacity among
        each row's top-FOLD_CHOICES), scatter into free bucket slots
        (donated update — no second table, no retrain), leave rows that fit
        nowhere in the spill. The IVF streaming-insert path: O(spill) work
        vs rebuild()'s O(corpus), so the auto-maintenance cadence can be
        aggressive. Returns rows folded. int8 + resident table only."""
        if (self.dtype != "int8" or self.data is None
                or self.centroids is None or not self.spill.count):
            return 0
        C, M, D = self.data.shape
        alive = np.asarray(self.spill.alive)[: self.spill.count] > 0
        s_ids = np.asarray(self.spill.ids, dtype=object)[: self.spill.count]
        if self._deleted:
            alive &= ~np.isin(s_ids.astype(str), sorted(self._deleted))
        ssel = np.nonzero(alive)[0]
        n = len(ssel)
        if n == 0:
            self.spill.delete_all()
            return 0
        PAD = 1 << 12
        n_pad = max(PAD, -(-n // PAD) * PAD)
        psel = np.full((n_pad,), self.spill.buf.shape[0], np.int64)  # OOB
        psel[:n] = ssel
        psel_d = jnp.asarray(psel)
        codes = jnp.take(self.spill.buf, psel_d, axis=0, mode="fill",
                         fill_value=0)
        scales = jnp.take(self.spill.scales, psel_d, mode="fill",
                          fill_value=0.0)
        # Top-R candidate clusters per row (device matmul, tiny fetch),
        # then the host-side greedy capacity fill.
        choice = _topk_clusters(codes, scales, self.centroids, n,
                                min(self.FOLD_CHOICES, C), mean=self.mean)
        a_final, slot_final, sizes_fill = _capacity_fill(
            choice, np.asarray(self.sizes), M)
        ok = a_final >= 0
        # destination per PADDED gather row (pads + unplaced rows -> OOB)
        dest = np.full((n_pad,), C * M, np.int64)
        dest[np.nonzero(ok)[0]] = a_final[ok] * M + slot_final[ok]
        n_fold = int(ok.sum())
        if n_fold == 0:
            return 0
        base = len(self.ids)
        rid_new = np.full((n_pad,), -1, np.int64)
        rid_new[:n] = base + np.arange(n)

        rid_dev = (self._rowids_dev if self._rowids_dev is not None
                   else jnp.asarray(self._rowids_host().astype(np.int32)))
        dest_dev = jnp.asarray(dest)
        self.data, self.rscales, self._rowids_dev = _fold_scatter(
            self.data, self.rscales, rid_dev, codes, scales,
            dest_dev, jnp.asarray(rid_new))
        if self.refine and self.resid is not None:
            rcodes = jnp.take(self.spill.rbuf, psel_d, axis=0, mode="fill",
                              fill_value=0)
            rscales2 = jnp.take(self.spill.rbuf_scales, psel_d, mode="fill",
                                fill_value=0.0)
            self.resid, self.resid_scales = _fold_scatter_resid(
                self.resid, self.resid_scales, rcodes, rscales2, dest_dev)
        if self.rowids is not None:
            # Host-built index: dest/rid_new are host values — mirror the
            # scatter instead of discarding the cache (a discarded cache
            # forces a full [C,M] device rowid fetch at the next save).
            self.rowids.reshape(-1)[dest[:n][ok]] = rid_new[:n][ok]
        self.sizes = jnp.asarray(sizes_fill.astype(np.int32))
        # ids: every gathered row gets a table entry; un-folded rows keep
        # id None there (their rowid never landed) and stay in the spill.
        folded_mask = ok
        sids_sel = s_ids[ssel]
        new_ids = np.full((n,), None, dtype=object)
        new_ids[folded_mask] = sids_sel[folded_mask]
        self.ids.extend(new_ids.tolist())
        # Host shadows: capture the spill's shadow rows BEFORE delete_all
        # replaces its arrays; mirror the scatter into the table shadow when
        # both sides are intact, else degrade to device-built semantics.
        sh_codes = sh_scales = sh_resid = sh_resid_sc = None
        if self.spill._sh_valid:
            sh_codes = self.spill._sh_rows[: self.spill.count][ssel]
            sh_scales = self.spill._sh_scales[: self.spill.count][ssel]
            if self.refine and self.spill._sh_resid is not None:
                sh_resid = self.spill._sh_resid[: self.spill.count][ssel]
                sh_resid_sc = (
                    self.spill._sh_resid_scales[: self.spill.count][ssel])
        if self._host_data is not None and sh_codes is not None:
            flat = self._host_data.reshape(C * M, D)
            fsc = self._host_scales.reshape(C * M)
            d_ok = dest[:n][folded_mask]
            flat[d_ok] = sh_codes[folded_mask]
            fsc[d_ok] = sh_scales[folded_mask]
            if self._host_resid is not None and sh_resid is not None:
                self._host_resid.reshape(C * M, D)[d_ok] = (
                    sh_resid[folded_mask])
                self._host_resid_scales.reshape(C * M)[d_ok] = (
                    sh_resid_sc[folded_mask])
        elif self._host_data is not None:
            self._host_data = self._host_scales = None
            self._host_resid = self._host_resid_scales = None
        # Rebuild the spill with only the leftover rows (device-to-device).
        # NOTE: ids whose spill copies were dropped here stay in `_deleted`:
        # the same id can also hold a (deleted) cluster-table row, and
        # un-marking it would resurrect that copy. rebuild() clears the set.
        left = ssel[~folded_mask]
        left_ids = sids_sel[~folded_mask].tolist()
        old_buf, old_scales = self.spill.buf, self.spill.scales
        old_rbuf, old_rbuf_sc = self.spill.rbuf, self.spill.rbuf_scales
        self.spill.delete_all()
        # delete_all un-pins the spill's mean; the leftover codes (and all
        # future spill adds) are still in THIS index's code space.
        if self.mean is not None:
            self.spill.mean = self.mean.copy()
        if len(left):
            lp = np.full((max(PAD, -(-len(left) // PAD) * PAD),),
                         old_buf.shape[0], np.int64)
            lp[: len(left)] = left
            lp_d = jnp.asarray(lp)
            self.spill.add_quantized(
                jnp.take(old_buf, lp_d, axis=0, mode="fill", fill_value=0),
                jnp.take(old_scales, lp_d, mode="fill", fill_value=0.0),
                left_ids + [None] * (len(lp) - len(left)),
                n_valid=len(left),
                # Leftover codes were sitting on the host whenever the old
                # shadow was valid — keep the new spill's shadow intact so
                # future checkpoints stay zero-device-fetch instead of
                # degrading to rows_skipped + SQL recovery.
                host_codes=(sh_codes[~folded_mask]
                            if sh_codes is not None else None),
                host_scales=(sh_scales[~folded_mask]
                             if sh_scales is not None else None),
                resid_dev=(jnp.take(old_rbuf, lp_d, axis=0, mode="fill",
                                    fill_value=0)
                           if self.refine and old_rbuf is not None else None),
                resid_scales_dev=(jnp.take(old_rbuf_sc, lp_d, mode="fill",
                                           fill_value=0.0)
                                  if self.refine and old_rbuf_sc is not None
                                  else None),
                host_resid=(sh_resid[~folded_mask]
                            if sh_resid is not None else None),
                host_resid_scales=(sh_resid_sc[~folded_mask]
                                   if sh_resid_sc is not None else None),
            )
        self._base_dirty = True
        return n_fold

    def rebuild(self) -> None:
        """Fold the spill back into retrained partitions. int8 indexes with
        a resident cluster table rebuild ON DEVICE (gather + re-assign +
        re-scatter; the corpus never transits the device->host link);
        others take the host path. Mean-centered indexes always rebuild on
        the host: they were host-ingested (device bulk builds pin a zero
        mean), so the corpus already lives in the host shadow, and the
        host path re-pins a fresh mean for the post-churn distribution."""
        live = len(self._live)
        if (self.dtype == "int8" and self.data is not None
                and live >= self.C * 4 and not self.refine
                and (self.mean is None or not self.mean.any())):
            # refine tables always rebuild on the host: they are
            # host-ingested by construction (build_device refuses refine),
            # and the device path would re-derive codes from coarse-only
            # reconstructions, silently discarding the residual store.
            self.rebuild_device()
            return
        vecs, ids = self._all_vectors()
        # Full reset BEFORE build: when the live set has shrunk below the
        # C*4 clustering floor, build() takes its spill-only early return —
        # clearing only spill+tombstones here would leave the OLD cluster
        # table installed with an emptied deleted set, resurrecting every
        # tombstoned row (and duplicating live ones into the spill).
        self.delete_all()
        if len(ids):
            self.build(vecs, ids)

    # -- vectorized live-row extraction (no per-row Python) -------------------

    def _live_cluster_mask(self) -> np.ndarray:
        """[C, M] bool: slot holds a live (in-size, rowid-valid, undeleted,
        non-nulled-id) row. Pure numpy over the host rowid table."""
        rowids = self._rowids_host()
        sizes = np.asarray(self.sizes)
        M = rowids.shape[1]
        valid = (np.arange(M)[None, :] < sizes[:, None]) & (rowids >= 0)
        if self._deleted or self._ids_nulled:
            ids_arr = np.asarray(self.ids, dtype=object)
            sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
            if self._ids_nulled:
                valid &= np.not_equal(sids, None)
            if self._deleted:
                valid &= ~np.isin(sids.astype(str), sorted(self._deleted))
        return valid

    def _cluster_live_ids(self, valid: np.ndarray) -> list:
        """Ids of the selected bucket slots, row-major (matches boolean-mask
        selection order)."""
        rid = self._rowids_host()[valid]
        return np.asarray(self.ids, dtype=object)[rid].tolist()

    def _all_vectors(self) -> tuple[np.ndarray, list[str]]:
        parts_v, parts_i = [], []
        if self.data is not None:
            valid = self._live_cluster_mask()
            if valid.any():
                data = np.asarray(self.data, dtype=np.float32 if
                                  self.dtype != "int8" else np.int8)
                sel = data[valid].astype(np.float32)
                if self.dtype == "int8":
                    sel *= np.asarray(self.rscales)[valid][:, None]
                    if self.refine and self.resid is not None:
                        # ~14-bit reconstruction: rebuild() re-quantizes
                        # from this, so fidelity must not degrade per cycle.
                        rq = (self._host_resid if self._host_resid is not None
                              else np.asarray(self.resid, dtype=np.int8))
                        rs = (self._host_resid_scales
                              if self._host_resid_scales is not None
                              else np.asarray(self.resid_scales))
                        sel += (rq[valid].astype(np.float32)
                                * rs[valid][:, None])
                # build() centers EVERY host-built table (float tiers
                # store v - mean too, not just int8) — decode back to raw
                # space for any dtype or rebuild() re-centers a mixture of
                # residual-space table rows and raw-space spill rows,
                # losing true top-1s by ~q*mean (advisor r3, high).
                if self.mean is not None and self.mean.any():
                    sel += self.mean  # rows are centered residuals
                parts_v.append(sel)
                parts_i.extend(self._cluster_live_ids(valid))
        if self.spill.count:
            alive = np.asarray(self.spill.alive)[: self.spill.count] > 0
            svecs = self.spill._dequantized()[alive]
            sids = np.asarray(self.spill.ids, dtype=object)[: self.spill.count][alive]
            if self._deleted:
                keep = ~np.isin(sids.astype(str), sorted(self._deleted))
                svecs, sids = svecs[keep], sids[keep]
            parts_v.append(svecs)
            parts_i.extend(sids.tolist())
        if not parts_v:
            return np.zeros((0, self.dim), np.float32), []
        return np.concatenate(parts_v), parts_i

    def rebuild_device(self) -> None:
        """Device-side rebuild for int8 indexes: gather live bucket + spill
        rows on device (host supplies only the [K] selection index — the
        cheap transfer direction), retrain, re-scatter via build_device().
        Selection lengths are padded to 64k multiples so eager gathers
        compile O(log) distinct executables; pad slots use positive OOB
        indices (fill/drop semantics) and are excluded from the build via
        n_valid."""
        assert self.dtype == "int8" and self.data is not None
        PAD = 1 << 16

        def _pad_to(sel: np.ndarray, oob: int) -> np.ndarray:
            target = max(PAD, -(-max(len(sel), 1) // PAD) * PAD)
            out = np.full((target,), oob, np.int64)
            out[: len(sel)] = sel
            return out

        valid = self._live_cluster_mask()
        sel = np.nonzero(valid.reshape(-1))[0]
        ids_out: list = self._cluster_live_ids(valid)
        n_live = len(sel)
        # Spill selection first (host metadata only) so the compacted
        # length T is known before the big gather.
        sids: list = []
        ssel = np.zeros((0,), np.int64)
        if self.spill.count:
            s_alive = np.asarray(self.spill.alive)[: self.spill.count] > 0
            s_ids = np.asarray(self.spill.ids, dtype=object)[: self.spill.count]
            if self._deleted:
                s_alive &= ~np.isin(s_ids.astype(str), sorted(self._deleted))
            ssel = np.nonzero(s_alive)[0]
            sids = s_ids[ssel].tolist()
        n_spill = len(ssel)
        n_valid = n_live + n_spill
        T = max(PAD, -(-n_valid // PAD) * PAD)
        # Gather the live bucket rows STRAIGHT INTO the compacted layout:
        # one [T]-index take whose positions [0, n_live) select live rows
        # and whose tail is OOB (fill 0). An eager zeros().at[].set()
        # compaction here would materialize three corpus-sized buffers at
        # once (operand, scatter output, gathered part — eager scatters
        # don't donate), ~12GB transient at the 10M tier: that exact OOM
        # wedged a recorded bench run.
        flat_rows = self.data.reshape(-1, self.dim)
        psel_np = np.full((T,), flat_rows.shape[0], np.int64)
        psel_np[:n_live] = sel
        psel = jnp.asarray(psel_np)
        all_codes = jnp.take(flat_rows, psel, axis=0, mode="fill", fill_value=0)
        all_scales = jnp.take(self.rscales.reshape(-1), psel,
                              mode="fill", fill_value=0.0)
        # Free the bucket table as soon as it is gathered from: at the 10M
        # tier the table (6.4GB) + gathered codes (4GB) + compacted corpus
        # (4GB) + the rebuilt table would exceed a 16GB chip. (Dropping the
        # reference is async-safe: the runtime keeps the buffer alive until
        # the queued gather completes.)
        del flat_rows
        self.data = self.rscales = self.sizes = None
        self.rowids = None
        self._rowids_dev = None
        if n_spill:
            pssel = jnp.asarray(_pad_to(ssel, self.spill.buf.shape[0]))
            part2_c = jnp.take(self.spill.buf, pssel, axis=0,
                               mode="fill", fill_value=0)
            part2_s = jnp.take(self.spill.scales, pssel,
                               mode="fill", fill_value=0.0)
            idx2 = jnp.asarray(_pad_to(
                n_live + np.arange(n_spill, dtype=np.int64), T)[: part2_c.shape[0]])
            # Donated in-place landing (fold_spill_scatter-style): the
            # eager .at[].set would copy the whole compacted corpus.
            all_codes, all_scales = _land_rows(all_codes, all_scales,
                                               part2_c, part2_s, idx2)
            del part2_c, part2_s
        ids_all = ids_out + sids + [None] * (T - n_valid)
        self.spill.delete_all()
        self._deleted.clear()
        self._live.clear()
        self.ids = []
        self.build_device(all_codes, all_scales, ids_all, n_valid=n_valid)

    # -- search --------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[str, float]]]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        Q = queries.shape[0]
        results: list[list[tuple[str, float]]] = [[] for _ in range(Q)]
        merged: list[dict[str, float]] = [dict() for _ in range(Q)]
        if self.data is not None:
            table_rows = int(np.asarray(self.sizes).sum())
            kk = min(k + len(self._deleted), table_rows)
            if self.rerank:
                # Retrieve a wider candidate set for the exact re-score.
                kk = min(max(kk, self.rerank), table_rows)
            if kk > 0:
                margin = 4.0 if self.prune_margin is None else self.prune_margin
                vals, cl, sl = _ivf_search(
                    self.centroids, self.data, self.rscales, self.sizes,
                    jnp.asarray(queries), jnp.float32(margin), self.nprobe,
                    kk)
                keep = min(k + len(self._deleted), kk)
                if self.rerank and kk > keep:
                    vals, cl, sl = _exact_topk_rerank(
                        self.data, self.rscales, jnp.asarray(queries),
                        jnp.asarray(vals), jnp.asarray(cl), jnp.asarray(sl),
                        keep, resid=self.resid,
                        resid_scales=self.resid_scales)
                from ..ops.host import fetch

                if self._rowids_dev is not None:
                    # Map winners to original rows on device: a [Q, k]
                    # gather instead of fetching the whole rowid table.
                    Mb = self.data.shape[1]
                    orig = jnp.take(
                        self._rowids_dev.reshape(-1),
                        jnp.asarray(cl) * Mb + jnp.asarray(sl),
                    )
                    vals, cl, sl, orig = fetch(vals, cl, sl, orig)
                else:
                    vals, cl, sl = fetch(vals, cl, sl)
                    orig = None
                # Centered codes: restore true cosines with the
                # query-constant q.mean (the kernels ranked by the
                # rank-equivalent residual score). Spill hits below come
                # back already corrected (FlatIndex does its own).
                off = (queries @ self.mean
                       if self.mean is not None and self.mean.any() else None)
                for qi in range(Q):
                    for j, (v, c, s) in enumerate(zip(vals[qi], cl[qi], sl[qi])):
                        if v <= -1e29:
                            continue
                        ridx = orig[qi, j] if orig is not None else self.rowids[c, s]
                        if ridx < 0:
                            continue
                        sid = self.ids[ridx]
                        if sid is None or sid in self._deleted:
                            continue
                        merged[qi][sid] = float(v) + (
                            float(off[qi]) if off is not None else 0.0)
        if self.spill.count:
            for qi, hits in enumerate(self.spill.search(queries, min(k, self.spill.count))):
                for sid, v in hits:
                    if sid not in self._deleted:
                        merged[qi][sid] = v
        for qi in range(Q):
            top = sorted(merged[qi].items(), key=lambda kv: -kv[1])[:k]
            results[qi] = [(sid, v) for sid, v in top]
        return results

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint: `{path}.npz` (cluster base: centroids + live rows in
        STORAGE precision + assignments + ids) + `{path}.meta.json` +
        `{path}.spill.*` (the spill FlatIndex's own incremental segment
        log). The base is immutable between (re)builds and written only
        when dirty, so streaming-ingest checkpoints move just the spill
        delta and the deleted-id list — no per-row Python, no [C,M,D]
        dequantization (load restores partitions without re-running
        k-means; rebuild() is the only path that retrains)."""
        import json as _json
        import os as _os

        _os.makedirs(_os.path.dirname(path) or ".", exist_ok=True)
        # Device-built bases (no host shadow) are NOT fetched by default:
        # a multi-GB base fetch is slow, and SQL is the durable source of
        # truth anyway — load() flags the index for SQL recovery instead.
        # Set MEMEX_CKPT_DEVICE_BASE=1 to force the fetch.
        skip_base = (self.data is not None and self._host_data is None
                     and self.dtype == "int8"
                     and _os.environ.get("MEMEX_CKPT_DEVICE_BASE") != "1")
        if skip_base:
            try:
                _os.remove(path + ".npz")  # drop any stale base
            except FileNotFoundError:
                pass
        elif self._base_dirty or path != self._ckpt_path or not _os.path.exists(
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
                # Base keeps every rowid-valid row; deletes live in meta
                # and are dropped at load (saves stay cheap under churn).
                # Nulled-id rows (stale copies killed by a delete->re-add)
                # must be dropped HERE: they are no longer in `_deleted`.
                valid = (np.arange(M)[None, :] < sizes[:, None]) & (rowids >= 0)
                if self._ids_nulled:
                    ids_arr = np.asarray(self.ids, dtype=object)
                    sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
                    valid &= np.not_equal(sids, None)
                arrs["cluster_assign"] = np.nonzero(valid)[0].astype(np.int32)
                arrs["cluster_ids"] = np.asarray(
                    np.asarray(self.ids, dtype=object)[rowids[valid]].tolist()
                )
                if self._host_data is not None:
                    # Host shadow: zero device bytes.
                    arrs_key = ("cluster_codes" if self.dtype == "int8"
                                else "cluster_vecs")
                    arrs[arrs_key] = self._host_data[valid]
                    if self.dtype == "int8":
                        arrs["cluster_scales"] = self._host_scales[valid]
                    if self.refine and self._host_resid is not None:
                        arrs["cluster_resid"] = self._host_resid[valid]
                        arrs["cluster_resid_scales"] = (
                            self._host_resid_scales[valid])
                elif self.dtype == "int8":
                    # Device-built table: compact live rows ON DEVICE first
                    # so the (slow) fetch moves only int8 codes, no bucket
                    # padding and no dequantized f32.
                    sel = jnp.asarray(np.nonzero(valid.reshape(-1))[0])
                    arrs["cluster_codes"] = np.asarray(
                        jnp.take(self.data.reshape(-1, self.dim), sel, axis=0))
                    arrs["cluster_scales"] = np.asarray(
                        jnp.take(self.rscales.reshape(-1), sel))
                else:
                    arrs["cluster_vecs"] = np.asarray(
                        self.data, dtype=np.float32)[valid]
            else:
                arrs["cluster_assign"] = np.zeros((0,), np.int32)
                arrs["cluster_ids"] = np.zeros((0,), np.str_)
                arrs["cluster_vecs"] = np.zeros((0, self.dim), np.float32)
            np.savez(path + ".npz", **arrs)
            self._base_dirty = False
            self._ckpt_path = path
        meta = {
            "format": 2,
            "dim": self.dim,
            "n_clusters": self.C,
            "nprobe": self.nprobe,
            "bucket_factor": self.bucket_factor,
            "dtype": self.dtype,
            "refine": self.refine,
            "deleted": sorted(str(s) for s in self._deleted),
            "base_skipped": bool(skip_base),
        }
        if self.mean is not None:
            meta["mean"] = [float(x) for x in self.mean]
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            _json.dump(meta, fh)
        _os.replace(tmp, path + ".meta.json")
        self.spill.save(path + ".spill")

    @classmethod
    def load(cls, path: str, **kw) -> "IVFIndex":
        import json as _json

        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = _json.load(fh)
        kw.setdefault("n_clusters", meta["n_clusters"])
        kw.setdefault("nprobe", meta["nprobe"])
        kw.setdefault("bucket_factor", meta["bucket_factor"])
        kw.setdefault("dtype", meta.get("dtype", "float32"))
        kw.setdefault("refine", meta.get("refine", False))
        idx = cls(dim=meta["dim"], **kw)
        if meta.get("format") != 2:
            return cls._load_legacy(idx, path, meta)
        if "mean" in meta:
            # Must land before any code is installed: the base and spill
            # segments hold codes centered at exactly this mean.
            idx.mean = np.asarray(meta["mean"], np.float32)
            idx.spill.mean = idx.mean.copy()
        deleted = set(meta.get("deleted", []))
        import os as _os

        if meta.get("base_skipped") or not _os.path.exists(path + ".npz"):
            # Device-built base was not persisted: restore the spill and
            # flag for SQL recovery (runtime.store() re-streams the rows).
            idx.needs_recovery = True
            if FlatIndex.exists(path + ".spill"):
                idx.spill = FlatIndex.load(path + ".spill", dtype=idx.dtype,
                                           center=False, rerank=idx.rerank,
                                           scan_precision=idx.scan_precision,
                                           refine=idx.refine)
                if deleted and idx.spill.count:
                    idx.spill.delete([s for s in idx.spill.ids if s in deleted])
                idx._live.update(idx.spill._id_to_row)
            if idx.mean is not None and idx.spill.mean is None:
                idx.spill.mean = idx.mean.copy()
            idx._ckpt_path = path
            return idx
        arrs = np.load(path + ".npz")
        cids_arr = arrs["cluster_ids"]
        centroids = arrs["centroids"]
        if len(centroids) and len(cids_arr):
            assign = arrs["cluster_assign"]
            if deleted:
                keep = ~np.isin(cids_arr.astype(str), sorted(deleted))
                cids_arr, assign = cids_arr[keep], assign[keep]
                # The on-disk base still CONTAINS the deleted rows; the
                # in-memory index no longer tracks them (filtered here, and
                # _deleted stays empty). Force the next save() to rewrite a
                # compacted base — otherwise it would pair the stale .npz
                # with meta deleted=[] and resurrect the rows on reload.
                idx._base_dirty = True
            else:
                keep = slice(None)
            idx.centroids = jnp.asarray(centroids)
            cids = [str(s) for s in cids_arr]
            counts = np.bincount(assign, minlength=idx.C)
            M = int(max(8, idx.bucket_factor * max(1, counts.mean())))
            M = max(M, int(counts.max()))
            M = -(-M // 1024) * 1024  # buckets in whole 1024-row units
            rowids = np.full((idx.C, M), -1, np.int64)
            idx.ids = cids
            # save() writes rows cluster-sorted, so positions are vectorizable
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(len(cids), dtype=np.int64) - starts[assign]
            rowids[assign, pos] = np.arange(len(cids))
            if "cluster_codes" in arrs:
                # int8 base restores the EXACT stored codes (no
                # dequantize/requantize round-trip).
                codes = np.zeros((idx.C, M, idx.dim), np.int8)
                rsc = np.zeros((idx.C, M), np.float32)
                codes[assign, pos] = arrs["cluster_codes"][keep]
                rsc[assign, pos] = arrs["cluster_scales"][keep]
                idx.data = jnp.asarray(codes)
                idx.rscales = jnp.asarray(rsc)
                idx._host_data, idx._host_scales = codes, rsc
                if idx.refine and "cluster_resid" in arrs:
                    rq = np.zeros((idx.C, M, idx.dim), np.int8)
                    rs2 = np.zeros((idx.C, M), np.float32)
                    rq[assign, pos] = arrs["cluster_resid"][keep]
                    rs2[assign, pos] = arrs["cluster_resid_scales"][keep]
                    idx.resid = jnp.asarray(rq)
                    idx.resid_scales = jnp.asarray(rs2)
                    idx._host_resid, idx._host_resid_scales = rq, rs2
            else:
                data = np.zeros((idx.C, M, idx.dim), np.float32)
                data[assign, pos] = arrs["cluster_vecs"][keep]
                idx._pack(data)
            idx.sizes = jnp.asarray(counts.astype(np.int32))
            idx.rowids = rowids
            idx._live.update(cids)
        if FlatIndex.exists(path + ".spill"):
            idx.spill = FlatIndex.load(path + ".spill", dtype=idx.dtype,
                                       center=False, rerank=idx.rerank,
                                       scan_precision=idx.scan_precision,
                                       refine=idx.refine)
            if deleted and idx.spill.count:
                idx.spill.delete([s for s in idx.spill.ids if s in deleted])
            idx._live.update(idx.spill._id_to_row)
            if idx.spill.needs_recovery:
                # Device-built spill rows were policy-skipped at save time.
                idx.needs_recovery = True
        if idx.mean is None and (idx.data is not None or idx.spill.count):
            # Pre-centering checkpoint: codes are raw — pin zero so later
            # ingestion can never re-center over them.
            idx.mean = np.zeros((idx.dim,), np.float32)
        if idx.mean is not None and idx.spill.mean is None:
            idx.spill.mean = idx.mean.copy()
        idx._ckpt_path = path
        return idx

    @classmethod
    def _load_legacy(cls, idx: "IVFIndex", path: str, meta: dict) -> "IVFIndex":
        """Round-1 single-npz format (dequantized f32 rows)."""
        arrs = np.load(path + ".npz")
        cids: list[str] = meta["cluster_ids"]
        centroids = arrs["centroids"]
        if len(centroids) and len(cids):
            idx.centroids = jnp.asarray(centroids)
            assign = arrs["cluster_assign"]
            vectors = arrs["cluster_vecs"]
            counts = np.bincount(assign, minlength=idx.C)
            M = int(max(8, idx.bucket_factor * max(1, counts.mean())))
            M = max(M, int(counts.max()))
            M = -(-M // 1024) * 1024
            data = np.zeros((idx.C, M, idx.dim), np.float32)
            rowids = np.full((idx.C, M), -1, np.int64)
            idx.ids = list(cids)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(len(cids), dtype=np.int64) - starts[assign]
            data[assign, pos] = vectors
            rowids[assign, pos] = np.arange(len(cids))
            idx._pack(data)
            idx.sizes = jnp.asarray(counts.astype(np.int32))
            idx.rowids = rowids
            idx._live.update(cids)
        sids = meta["spill_ids"]
        if sids:
            idx.spill.add(arrs["spill_vecs"], sids)
            idx._live.update(sids)
        return idx

    @classmethod
    def exists(cls, path: str) -> bool:
        import json as _json
        import os as _os

        if not _os.path.exists(path + ".meta.json"):
            return False
        if _os.path.exists(path + ".npz"):
            return True
        try:
            with open(path + ".meta.json", "r", encoding="utf-8") as fh:
                return bool(_json.load(fh).get("base_skipped"))
        except (OSError, _json.JSONDecodeError):
            return False

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        import os as _os

        FlatIndex.remove_checkpoint(path + ".spill")
        for suffix in (".npz", ".meta.json"):
            try:
                _os.remove(path + suffix)
            except FileNotFoundError:
                pass

    def delete(self, ids: list[str]) -> int:
        if isinstance(ids, str):
            ids = [ids]  # a bare string would iterate characters and no-op
        # `_live` is exactly (table ids ∪ spill ids) − deleted, maintained
        # by build/add/delete — an O(batch) membership test instead of the
        # old O(corpus) scan over self.ids per delete call.
        removed = 0
        for sid in ids:
            if sid in self._live:
                self._deleted.add(sid)
                self._live.discard(sid)
                removed += 1
        self.spill.delete(list(ids))
        return removed

    def delete_all(self) -> None:
        self.centroids = None
        self.data = None
        self.resid = None
        self.resid_scales = None
        self.sizes = None
        self.rowids = None
        self._rowids_dev = None
        self.ids = []
        self._ids_nulled = False
        self._deleted.clear()
        self._live.clear()
        self.spill.delete_all()
        self.mean = None  # re-pinned at the next ingestion
        self._base_dirty = True
        self._host_data = self._host_scales = None
        self._host_resid = self._host_resid_scales = None

    def calibrate_margin(self, queries: np.ndarray | None = None,
                         k: int = 10, target_overlap: float = 0.97,
                         margins=None, n_queries: int = 64,
                         seed: int = 0,
                         target_metric: str = "overlap") -> float | None:
        """Auto-tune prune_margin to a recall target; see
        calibrate_prune_margin."""
        return calibrate_prune_margin(
            self, queries=queries, k=k, target_overlap=target_overlap,
            margins=margins, n_queries=n_queries, seed=seed,
            target_metric=target_metric)

    def calibrate_operating_point(self, queries: np.ndarray | None = None,
                                  k: int = 10, target_recall: float = 0.95,
                                  nprobes=None, n_queries: int = 64,
                                  seed: int = 0, margins=None) -> dict | None:
        """Jointly pick (nprobe, prune_margin) against a recall floor; see
        calibrate_operating_point."""
        return calibrate_operating_point(
            self, queries=queries, k=k, target_recall=target_recall,
            nprobes=nprobes, n_queries=n_queries, seed=seed, margins=margins)


# -- prune-margin auto-calibration (shared by IVFIndex / ShardedIVFIndex) ---

# Ascending sweep grid: the first (smallest = most aggressive) margin
# holding the overlap target wins. Cosine units; 0.5 is already nearly
# keep-all on clustered corpora.
CALIBRATION_MARGINS = (0.05, 0.08, 0.12, 0.17, 0.25, 0.35, 0.5)


def sample_corpus_queries(index, n: int, seed: int = 0) -> np.ndarray | None:
    """Draw n probe queries from the index's own cluster table (dequantized
    live-ish rows, re-normalized). Corpus rows are the right calibration
    distribution: real queries land where the corpus is dense, which is
    exactly where margin pruning must hold its recall. ~n*D*4 bytes fetched
    (64 queries at 384-d is ~100 KB)."""
    if index.data is None:
        return None
    sizes = np.asarray(index.sizes)
    live = np.nonzero(sizes > 0)[0]
    if live.size == 0:
        return None
    rng = np.random.default_rng(seed)
    cl = rng.choice(live, size=n)
    M = index.data.shape[1]
    sl = np.floor(rng.random(n) * sizes[cl]).astype(np.int64)
    flat = jnp.asarray(cl * M + sl)
    rows = jnp.take(index.data.reshape(-1, index.dim), flat,
                    axis=0).astype(jnp.float32)
    mean = getattr(index, "mean", None)
    if index.rscales is not None:
        rows = rows * jnp.take(index.rscales.reshape(-1), flat)[:, None]
    q = np.asarray(jax.device_get(rows), np.float32)
    if mean is not None and np.asarray(mean).any():
        q = q + np.asarray(mean, np.float32)  # codes are centered residuals
    nrm = np.linalg.norm(q, axis=1, keepdims=True)
    return q / np.maximum(nrm, 1e-9)


def calibrate_prune_margin(index, queries: np.ndarray | None = None,
                           k: int = 10, target_overlap: float = 0.97,
                           margins=None, n_queries: int = 64,
                           seed: int = 0,
                           target_metric: str = "overlap") -> float | None:
    """Pick the smallest (fastest) prune margin whose pruned top-k keeps
    >= target_overlap of the baseline result on probe queries, then set it
    as index.prune_margin and return it.

    target_metric="overlap" (default): baseline = the UNPRUNED batch-union
    search. No external oracle needed — pruning only ever drops probes, so
    the unpruned search is the recall ceiling it approaches from below;
    overlap against it bounds the recall loss PRUNING can add (but not the
    loss nprobe routing already had).

    target_metric="recall": baseline = a FULL-PROBE search (nprobe=C, no
    pruning) — exact over table+spill within storage precision — so the
    target is recall-vs-exact, routing loss included (round-2 verdict: the
    overlap target understated recall on corpora where nprobe itself
    misses). Costs one extra executable at the all-probe shape.

    The margin is a dynamic scalar in every kernel involved, so the whole
    ascending sweep reuses one compiled executable per batch shape.
    Returns None (pruning off) when nothing meets the target or the index
    has no cluster table yet."""
    if target_metric not in ("overlap", "recall"):
        raise ValueError(f"unknown target_metric {target_metric!r}")
    if margins is None:
        margins = CALIBRATION_MARGINS
    if queries is None:
        queries = sample_corpus_queries(index, n_queries, seed=seed)
    if queries is None:
        index.prune_margin = None
        return None
    prev = index.prune_margin
    prev_nprobe = index.nprobe
    index.prune_margin = None
    if target_metric == "recall":
        index.nprobe = index.C
    try:
        base = index.search(queries, k)
    except Exception:
        index.prune_margin = prev
        raise
    finally:
        index.nprobe = prev_nprobe
    base_sets = [frozenset(sid for sid, _ in hits) for hits in base]
    denom = [max(len(b), 1) for b in base_sets]
    for m in sorted(margins):
        index.prune_margin = float(m)
        pruned = index.search(queries, k)
        overlap = float(np.mean([
            len(base_sets[i] & {sid for sid, _ in pruned[i]}) / denom[i]
            for i in range(len(base_sets))
        ]))
        if overlap >= target_overlap:
            logger.info("prune_margin calibrated: %.3f (overlap %.3f >= %.2f)",
                        m, overlap, target_overlap)
            return index.prune_margin
    index.prune_margin = None
    logger.info("prune_margin calibration: no margin held overlap >= %.2f; "
                "pruning disabled", target_overlap)
    return None


def _nprobe_ladder(start: int, C: int) -> list[int]:
    """Doubling ladder from the configured nprobe up to C: O(log C)
    candidate executables, and the final rung (nprobe=C, i.e. full probe)
    holds ANY recall target by construction, so the sweep always lands."""
    ladder, v = [], max(1, int(start))
    while v < C:
        ladder.append(v)
        v *= 2
    ladder.append(C)
    return ladder


def calibrate_operating_point(index, queries: np.ndarray | None = None,
                              k: int = 10, target_recall: float = 0.95,
                              nprobes=None, n_queries: int = 64,
                              seed: int = 0, margins=None) -> dict | None:
    """Jointly pick (nprobe, prune_margin) against a recall floor.

    Margin calibration alone cannot LIFT recall: pruning only ever drops
    probes, so when the configured nprobe itself routes past the true
    neighbors — which happens on hard, anisotropic corpora (real-text
    embeddings concentrate far more than Gaussian mixtures; round-2
    verdict item 6) — no margin reaches the floor. This fixes the recall
    ceiling first (smallest ladder nprobe whose unpruned search holds
    >= target_recall vs a full-probe baseline), then runs the margin sweep
    at that nprobe to buy the speed back under the same floor.

    The baseline (nprobe=C, no pruning) is exact within storage precision,
    so the floor is recall-vs-exact with routing loss included;
    quantization loss is a storage-tier property no routing knob can
    recover, and is measured separately by the benches. Sets index.nprobe
    and index.prune_margin in place; returns {"nprobe", "prune_margin",
    "recall_vs_full", "sweep"} or None when the index has no cluster
    table / probe queries (spill-only collections route nothing)."""
    if queries is None:
        queries = sample_corpus_queries(index, n_queries, seed=seed)
    if queries is None:
        return None
    prev_nprobe, prev_margin = index.nprobe, index.prune_margin
    index.prune_margin = None
    index.nprobe = index.C
    try:
        base = index.search(queries, k)
    except Exception:
        index.nprobe, index.prune_margin = prev_nprobe, prev_margin
        raise
    base_sets = [frozenset(sid for sid, _ in hits) for hits in base]
    denom = [max(len(b), 1) for b in base_sets]
    if nprobes is None:
        nprobes = _nprobe_ladder(prev_nprobe, index.C)
    ladder = sorted({int(x) for x in nprobes if 0 < int(x) <= index.C})
    if not ladder:
        ladder = [index.C]
    sweep: list[dict] = []
    # A transient failure mid-sweep (OOM, lost device) must not leave
    # the serving operating point at an arbitrary ladder rung (possibly
    # nprobe=C full-probe) with the margin cleared — restore the previous
    # point before re-raising, like the baseline guard above (advisor r3).
    try:
        for cand in ladder:
            index.nprobe = cand
            if cand == index.C:
                rec = 1.0  # the baseline itself
            else:
                hits = index.search(queries, k)
                rec = float(np.mean([
                    len(base_sets[i] & {sid for sid, _ in hits[i]}) / denom[i]
                    for i in range(len(base_sets))
                ]))
            sweep.append({"nprobe": cand, "recall_vs_full": round(rec, 4)})
            if rec >= target_recall:
                break
        margin = calibrate_prune_margin(
            index, queries=queries, k=k, target_overlap=target_recall,
            margins=margins, target_metric="recall")
    except Exception:
        index.nprobe, index.prune_margin = prev_nprobe, prev_margin
        raise
    point = {"nprobe": index.nprobe, "prune_margin": margin,
             "recall_vs_full": sweep[-1]["recall_vs_full"], "sweep": sweep}
    logger.info("operating point calibrated: nprobe=%d margin=%s "
                "(recall %.3f >= %.2f vs full probe)", index.nprobe, margin,
                sweep[-1]["recall_vs_full"], target_recall)
    return point
