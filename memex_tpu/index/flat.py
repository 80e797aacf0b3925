"""FlatIndex — exact brute-force vector index resident on device.

The device-resident replacement for the reference HNSW file store
(lib/libmemex/src/storage/local.rs). Key inversions of the reference's
design, per SURVEY.md §3 "known inefficiencies":

  - reference re-saves the whole index after every insert (local.rs:62-69)
    → here the device buffer IS the index; checkpointing is explicit and
    O(count) only when requested;
  - reference reloads the index from disk per query (storage/mod.rs:107-121)
    → here the buffer persists on device across queries;
  - reference delete-one is unimplemented (local.rs:29-32) → here deletes
    are tombstones applied at score time, compacted opportunistically.

XLA-friendliness: the buffer has a fixed power-of-two capacity; `count` and
the tombstone mask are device values, so ingest/search never recompile as
the index fills (SURVEY.md §7 hard part (b)). Capacity growth doubles the
buffer (new executable per capacity, ~log2 growth events total).

Adds are O(batch) dynamic-slice writes with donated buffers (no copy of the
untouched region). Search runs the fused score+top-k kernel
(ops/scan_topk.py) on a GPU or the two-stage XLA path, as
ops/scan_topk.use_kernel chooses.
"""

from __future__ import annotations

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..log import get_logger
from ..ops.quant import np_quantize_rows_int4
from ..ops.scan_topk import MAX_K, scan_topk, use_kernel
from ..ops.topk import blockwise_topk

logger = get_logger(__name__)

MIN_CAPACITY = 2048
_ADD_BUCKETS = (8, 64, 256, 1024)
# Bulk-add streaming chunk (rows): pow2 so every chunk of a large load
# lands on one compiled write shape, sized so a chunk's int8 block
# (~48MB at D=384) transfers while the host preps the next chunk.
_ADD_CHUNK = 1 << 17


def _bucket_rows(m: int) -> int:
    for b in _ADD_BUCKETS:
        if m <= b:
            return b
    return -(-m // _ADD_BUCKETS[-1]) * _ADD_BUCKETS[-1]


@partial(jax.jit, donate_argnums=(0,))
def _write_block(buf, block, start, nvalid):
    """Write `block` rows at [start, start+rows) preserving rows >= nvalid.

    Deterministic read-modify-write: rows of the padded block beyond nvalid
    keep the buffer's existing contents.
    """
    rows = block.shape[0]
    tail = jax.lax.dynamic_slice(buf, (start, 0), (rows, buf.shape[1]))
    row_ids = jax.lax.broadcasted_iota(jnp.int32, block.shape, 0)
    merged = jnp.where(row_ids < nvalid, block, tail)
    return jax.lax.dynamic_update_slice(buf, merged, (start, 0))


@partial(jax.jit, donate_argnums=(0,))
def _write_block_cols(buf, block, start, nvalid):
    """Column variant of _write_block for the transposed int4 buffer
    [D/2, capacity]: write `block` [D/2, rows] at columns [start, start+rows),
    preserving columns >= nvalid."""
    rows = block.shape[1]
    tail = jax.lax.dynamic_slice(buf, (0, start), (buf.shape[0], rows))
    col_ids = jax.lax.broadcasted_iota(jnp.int32, block.shape, 1)
    merged = jnp.where(col_ids < nvalid, block, tail)
    return jax.lax.dynamic_update_slice(buf, merged, (0, start))


@partial(jax.jit, static_argnames=("keep",))
def _exact_flat_rerank(buf, scales, queries, vals, idx, keep: int,
                       rbuf=None, rbuf_scales=None):
    """Exact re-scoring of a coarse search's top-kk rows, on device (the
    flat-index twin of ivf._exact_topk_rerank): gather the candidate rows
    and redo the dot at HIGHEST precision — the coarse paths feed the
    tensor cores bf16 inputs, whose resolution near 1.0 scrambles top-k
    boundaries on strongly anisotropic corpora. With a refinement store
    (rbuf: int8 codes of the quantization residual, per-row rbuf_scales)
    the gather also reads the residual codes and reconstructs at ~14 effective bits
    — int8 storage then reranks at near-f32 fidelity, which dequantizing
    the same coarse codes can never do (r3 verdict item 2; reference bar:
    HNSW scores original f32 rows, local.rs:71-91). Sentinel candidates
    (vals <= -1e29) keep their sentinel. Returns (vals, idx) [Q,keep]."""
    rows = buf[idx].astype(jnp.float32)  # [Q, kk, D]
    if scales is not None:
        rows = rows * scales[idx][..., None]
    if rbuf is not None:
        rows = rows + rbuf[idx].astype(jnp.float32) * rbuf_scales[idx][..., None]
    scores = jnp.einsum("qd,qkd->qk", queries.astype(jnp.float32), rows,
                        precision=jax.lax.Precision.HIGHEST)
    scores = jnp.where(vals > -1e29, scores, vals)
    top_v, top_j = jax.lax.top_k(scores, keep)
    return top_v, jnp.take_along_axis(idx, top_j, axis=1)


@partial(jax.jit, static_argnames=("k", "exact"))
def _search_xla(buf, scales, alive, count, queries, k: int,
                exact: bool = False):
    """Plain XLA scan for any storage dtype: a [Q, N] score matrix, then
    a blockwise top-k. bf16 inputs with f32 accumulation, like the fused
    kernel's default mode; exact=True (f32 storage) keeps f32 inputs at
    HIGHEST precision. alive=None skips the tombstone mask."""
    scores = jnp.einsum(
        "qd,nd->qn",
        queries if exact else queries.astype(jnp.bfloat16),
        buf if exact else buf.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
        precision=(jax.lax.Precision.HIGHEST if exact
                   else jax.lax.Precision.DEFAULT),
    )
    if scales is not None:
        scores = scores * scales[None, :]
    if alive is not None:
        scores = jnp.where(alive[None, :] > 0, scores, -1e30)
    return blockwise_topk(scores, k, count=count)


def scan_mode(dtype: str, query_quantize: bool, scan_precision: str) -> str:
    """The scan arithmetic for a store configuration: "int8q" (int8 x int8)
    for quantized tiers with query quantization, "exact" (f32 at HIGHEST,
    XLA only) for scan_precision="highest", else "bf16"."""
    if dtype in ("int8", "int4"):
        return "int8q" if query_quantize else "bf16"
    return "exact" if scan_precision == "highest" else "bf16"


@partial(jax.jit, static_argnames=("k", "k_ret", "kernel", "mode",
                                   "interpret"))
def device_search(buf, scales, alive, count, queries, rbuf, rbuf_scales, *,
                  k: int, k_ret: int, kernel: bool, mode: str,
                  interpret: bool = False):
    """The flat search, shared by FlatIndex.search and the serve path's
    encode+scan executable: scan for the top-k_ret rows (fused kernel or
    plain XLA, as `use_kernel` chose), then, when k_ret > k, the exact
    rerank of those candidates. buf is the [N, D] scan buffer (int4
    stores pass their int8 copy); alive=None means no tombstones."""
    if kernel:
        vals, idx = scan_topk(buf, queries, scales, alive, count, k_ret,
                              mode=mode, interpret=interpret)
    else:
        vals, idx = _search_xla(buf, scales, alive, count, queries, k_ret,
                                exact=mode == "exact")
    if k_ret > k:
        vals, idx = _exact_flat_rerank(buf, scales, queries, vals, idx, k,
                                       rbuf=rbuf, rbuf_scales=rbuf_scales)
    return vals, idx


class FlatIndex:
    """Exact cosine/MIPS index over unit vectors, resident on one device.

    API parity with the reference VectorStore trait
    (lib/libmemex/src/storage/mod.rs:54-66): insert/bulk_insert/search/
    delete/delete_all, with string ids.
    """

    def __init__(self, dim: int, capacity: int = MIN_CAPACITY,
                 dtype: str = "float32",
                 query_quantize: bool = True, center: bool | None = None,
                 rerank: int | None = None, scan_precision: str = "default",
                 refine: bool = False):
        """dtype selects storage precision: "float32" (exact), "bfloat16"
        (half the scan bytes, ~1e-3 score error), "int8" (a quarter of the
        bytes, ScaNN-style per-row scales, small recall cost), "int4"
        (packed nibbles beside an int8 copy; the scan reads the int8 copy).
        query_quantize makes the fused kernel quantize queries to int8 as
        well, so quantized tiers score int8 x int8 on the tensor cores."""
        assert dtype in ("float32", "bfloat16", "int8", "int4"), dtype
        assert dtype != "int4" or dim % 2 == 0, "int4 packing needs even dim"
        self.dim = dim
        self.dtype = dtype
        # Anisotropy-corrected quantization: real sentence embeddings
        # concentrate around a large common mean (measured: random- and
        # pretrained-MiniLM corpora sit at pairwise cos 0.95+), so direct
        # int8 quantization burns nearly the whole code range on the shared
        # component and the informative residual drowns in rounding noise.
        # Storing codes = quantize(v - mean) spends the range on the
        # residual; ranking is unchanged (score q.v = q.mean + q.delta and
        # q.mean is query-constant across rows) and true cosines are
        # restored by adding q.mean on the host AFTER the device top-k —
        # zero changes to any compiled kernel. The mean is pinned at the
        # first quantized ingestion (even a small first batch estimates it
        # well on exactly the concentrated corpora that need it) and only a
        # compact/rebuild re-pins it. Isotropic corpora pin a near-zero
        # mean and behave as before. `center` defaults on for EVERY tier:
        # float storage has no rounding step, but the scan feeds the tensor
        # cores bf16 inputs (8-bit mantissa), and on concentrated corpora the
        # informative score differences sit below bf16 resolution of values
        # near 1.0 — storing the residual moves them back into range
        # (measured: recall@10 vs exact 0.13 raw -> 0.92+ centered at
        # pairwise cos 0.9985, bf16-simulated scoring).
        self.center = True if center is None else bool(center)
        self.mean: np.ndarray | None = None  # None = not pinned yet
        # Residual-refinement store (quantized tiers): alongside each int8
        # code, keep an int8 code of the QUANTIZATION RESIDUAL
        # (v - code*scale) with its own per-row scale. The coarse scan
        # never reads it (zero QPS cost on the hot path); the exact-rerank
        # gather reads both codes and reconstructs rows at ~14 effective
        # bits, so the rerank ranks by near-f32 scores instead of
        # re-deriving the same 8-bit values. Costs +N*(D+4) bytes of HBM.
        # Implies rerank (a refinement store without a rerank pass is
        # dead weight): defaults the depth to the fused kernels' ceiling.
        assert not refine or dtype in ("int8", "int4"), \
            "refine stores a residual of the quantization error; " \
            f"{dtype} storage has none"
        self.refine = bool(refine)
        if self.refine and rerank is None:
            rerank = 128
        # Opt-in exact re-scoring depth (see _exact_flat_rerank): retrieve
        # the top-`rerank` coarse candidates, re-score them at HIGHEST
        # precision on device, keep the true top-k. Capped at MAX_K (the
        # fused kernel's k ceiling).
        self.rerank = None if rerank is None else min(int(rerank), MAX_K)
        # scan_precision="highest" (f32 storage only): the scan keeps f32
        # inputs at full precision, so candidates are selected by EXACT
        # scores (ops/scan_topk.py "exact" mode).
        assert scan_precision in ("default", "highest"), scan_precision
        # Documented contract: exact scan needs f32 storage. Quantized
        # tiers would silently ignore the flag on the fused path while the
        # XLA fallback applied HIGHEST anyway — two score resolutions for
        # one config (advisor r3, low). Fail loud at construction instead.
        assert scan_precision == "default" or dtype == "float32", (
            f"scan_precision='highest' requires float32 storage, got {dtype}")
        self.scan_precision = scan_precision
        capacity = max(MIN_CAPACITY, int(capacity))
        self.capacity = 1 << (capacity - 1).bit_length()  # power of two
        self.count = 0
        self.dead = 0
        self.query_quantize = query_quantize
        self._interpret = False  # tests: run the fused kernel interpreted
        self.ids: list[str] = []
        self._id_to_row: dict[str, int] = {}
        self._buf_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                           "int8": jnp.int8, "int4": jnp.int8}[dtype]
        # int4 mode: `buf` holds packed nibbles TRANSPOSED [dim/2, cap] (the
        # tile-aligned kernel layout; [N, dim/2]'s 192-lane minor dim would
        # relayout the whole array every search); `buf8` holds the int8
        # rerank copy [cap, dim]; one scale array serves both stages
        # (int4 scale = int8 scale * 127/7 exactly, same per-row absmax).
        if dtype == "int4":
            self.buf = jnp.zeros((dim // 2, self.capacity), jnp.int8)
        else:
            self.buf = jnp.zeros((self.capacity, dim), self._buf_dtype)
        self.buf8 = (
            jnp.zeros((self.capacity, dim), jnp.int8) if dtype == "int4" else None
        )
        self.scales = (
            jnp.zeros((self.capacity,), jnp.float32)
            if dtype in ("int8", "int4") else None
        )
        # Refinement store: residual codes + scales (see `refine` above).
        # Device-built rows (add_quantized without host residuals) keep
        # scale 0 — their reconstruction degrades gracefully to coarse.
        self.rbuf = (jnp.zeros((self.capacity, dim), jnp.int8)
                     if self.refine else None)
        self.rbuf_scales = (jnp.zeros((self.capacity,), jnp.float32)
                            if self.refine else None)
        self.alive = jnp.zeros((self.capacity,), jnp.float32)
        # Write-through host shadow: every serving-path row passes through
        # the host in add() (quantization happens there), so mirroring it
        # costs one memcpy and makes save()/compact() zero-device-fetch.
        # Whether the shadow still pays on a local host link is ROADMAP
        # D4's question. int4 mode
        # shadows the int8 rerank copy (the higher-fidelity one; the packed
        # nibbles are re-derived on load). Device-built rows
        # (add_quantized) invalidate the shadow; save() then falls back to
        # a one-shot device fetch.
        self._sh_dtype = np.int8 if dtype in ("int8", "int4") else np.float32
        self._sh_rows = np.zeros((self.capacity, dim), self._sh_dtype)
        self._sh_scales = (
            np.zeros((self.capacity,), np.float32)
            if dtype in ("int8", "int4") else None
        )
        self._sh_resid = (np.zeros((self.capacity, dim), np.int8)
                          if self.refine else None)
        self._sh_resid_scales = (np.zeros((self.capacity,), np.float32)
                                 if self.refine else None)
        self._sh_valid = True
        # Incremental-checkpoint state (see save()). Dead rows are tracked
        # by ROW INDEX (stable within a generation), not by id: an id-based
        # tombstone would also kill a later re-added live row with the same
        # id at load time.
        self.needs_recovery = False  # set by load() when rows were skipped
        self._generation = 0
        self._dead_rows: set[int] = set()
        self._ckpt_path: str | None = None
        self._ckpt_gen = -1
        self._saved_count = 0
        self._segments: list[str] = []

    # -- mutation -------------------------------------------------------------

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        logger.info("flat index grow %d -> %d", self.capacity, new_cap)
        pad = new_cap - self.capacity
        if self.dtype == "int4":
            self.buf = jnp.concatenate(
                [self.buf, jnp.zeros((self.buf.shape[0], pad), jnp.int8)], axis=1
            )
        else:
            self.buf = jnp.concatenate(
                [self.buf, jnp.zeros((pad, self.dim), self._buf_dtype)]
            )
        if self.buf8 is not None:
            self.buf8 = jnp.concatenate([self.buf8, jnp.zeros((pad, self.dim), jnp.int8)])
        if self.scales is not None:
            self.scales = jnp.concatenate([self.scales, jnp.zeros((pad,), jnp.float32)])
        if self.rbuf is not None:
            self.rbuf = jnp.concatenate(
                [self.rbuf, jnp.zeros((pad, self.dim), jnp.int8)])
            self.rbuf_scales = jnp.concatenate(
                [self.rbuf_scales, jnp.zeros((pad,), jnp.float32)])
        self.alive = jnp.concatenate([self.alive, jnp.zeros((pad,), jnp.float32)])
        self._sh_rows = np.concatenate(
            [self._sh_rows, np.zeros((pad, self.dim), self._sh_dtype)]
        )
        if self._sh_scales is not None:
            self._sh_scales = np.concatenate(
                [self._sh_scales, np.zeros((pad,), np.float32)]
            )
        if self._sh_resid is not None:
            self._sh_resid = np.concatenate(
                [self._sh_resid, np.zeros((pad, self.dim), np.int8)])
            self._sh_resid_scales = np.concatenate(
                [self._sh_resid_scales, np.zeros((pad,), np.float32)])
        self.capacity = new_cap

    def add(self, vectors: np.ndarray, ids: list[str]) -> None:
        """Bulk insert (reference bulk_insert, storage/mod.rs:58). Vectors
        must be unit-normalized [M, dim]."""
        vectors = np.asarray(vectors, dtype=np.float32)
        assert vectors.shape[0] == len(ids) and vectors.shape[1] == self.dim
        if len(set(ids)) < len(ids):
            # Intra-batch duplicates: keep the LAST occurrence per id —
            # two live rows under one id would make the first an
            # undeletable ghost (delete() can only tombstone the row
            # _id_to_row points at).
            last = {sid: i for i, sid in enumerate(ids)}
            pick = sorted(last.values())
            vectors = vectors[pick]
            ids = [ids[i] for i in pick]
        if any(sid in self._id_to_row for sid in ids):
            # Idempotent re-add (e.g. a rebuild raced an ingest): keep the
            # existing row, insert only genuinely new ids.
            fresh = [i for i, sid in enumerate(ids) if sid not in self._id_to_row]
            if not fresh:
                return
            vectors = vectors[fresh]
            ids = [ids[i] for i in fresh]
        if vectors.shape[0] > _ADD_CHUNK:
            # Stream large bulk loads in fixed pow2 chunks: host-side
            # quantize/prep of chunk i+1 overlaps the (async) H2D
            # transfer of chunk i, and every chunk hits ONE compiled
            # write shape. Screening above already removed duplicates.
            self._grow_to(self.count + vectors.shape[0] + 1)  # once, not per chunk
            for i in range(0, vectors.shape[0], _ADD_CHUNK):
                self._add_screened(vectors[i : i + _ADD_CHUNK],
                                   ids[i : i + _ADD_CHUNK])
            return
        self._add_screened(vectors, ids)

    def _add_screened(self, vectors: np.ndarray, ids: list[str],
                      precentered: bool = False) -> None:
        m = vectors.shape[0]
        rows = _bucket_rows(m)
        # +1 so padded rows never alias live data at exactly-full capacity.
        self._grow_to(self.count + rows + 1)
        if self.mean is None:
            self.mean = (vectors.mean(axis=0).astype(np.float32)
                         if self.center and not precentered
                         else np.zeros((self.dim,), np.float32))
        resid = (vectors if precentered or not self.mean.any()
                 else vectors - self.mean)
        if self.dtype in ("int8", "int4"):
            if self.refine:
                from ..native_lib import np_quantize_rows_int8_refine
                q, row_scales, rq, rq_scales = np_quantize_rows_int8_refine(
                    np.ascontiguousarray(resid, np.float32))
                self._sh_resid[self.count : self.count + m] = rq
                self._sh_resid_scales[self.count : self.count + m] = rq_scales
                rqblock = np.zeros((rows, self.dim), np.int8)
                rqblock[:m] = rq
                rsblock = np.zeros((rows,), np.float32)
                rsblock[:m] = rq_scales
                self.rbuf = _write_block(
                    self.rbuf, jnp.asarray(rqblock), self.count, m)
                self.rbuf_scales = _write_block(
                    self.rbuf_scales[:, None], jnp.asarray(rsblock)[:, None],
                    self.count, m)[:, 0]
            else:
                from ..native_lib import np_quantize_rows_int8
                q, row_scales = np_quantize_rows_int8(
                    np.ascontiguousarray(resid, np.float32))
            self._sh_rows[self.count : self.count + m] = q
            self._sh_scales[self.count : self.count + m] = row_scales
            qblock = np.zeros((rows, self.dim), np.int8)
            qblock[:m] = q
            sblock = np.zeros((rows,), np.float32)
            sblock[:m] = row_scales
            if self.dtype == "int4":
                p, _ = np_quantize_rows_int4(resid)  # [D/2, m]; scales = s8*127/7
                pblock = np.zeros((self.dim // 2, rows), np.int8)
                pblock[:, :m] = p
                self.buf = _write_block_cols(
                    self.buf, jnp.asarray(pblock), self.count, m
                )
                self.buf8 = _write_block(self.buf8, jnp.asarray(qblock), self.count, m)
            else:
                self.buf = _write_block(self.buf, jnp.asarray(qblock), self.count, m)
            self.scales = _write_block(
                self.scales[:, None], jnp.asarray(sblock)[:, None], self.count, m
            )[:, 0]
        else:
            # Float tiers store the residual too (shadow mirrors storage
            # space exactly, like int8 codes); search()/decode() restore
            # the query-constant q.mean after the device top-k.
            self._sh_rows[self.count : self.count + m] = resid
            block = np.zeros((rows, self.dim), np.float32)
            block[:m] = resid
            self.buf = _write_block(
                self.buf, jnp.asarray(block).astype(self._buf_dtype), self.count, m
            )
        ones = np.zeros((rows,), np.float32)
        ones[:m] = 1.0
        self.alive = _write_block(
            self.alive[:, None], jnp.asarray(ones)[:, None], self.count, m
        )[:, 0]
        for i, sid in enumerate(ids):
            self._id_to_row[sid] = self.count + i
        self.ids.extend(ids)
        self.count += m

    def add_quantized(self, codes_dev, scales_dev, ids: list[str],
                      n_valid: int | None = None,
                      host_codes: np.ndarray | None = None,
                      host_scales: np.ndarray | None = None,
                      resid_dev=None, resid_scales_dev=None,
                      host_resid: np.ndarray | None = None,
                      host_resid_scales: np.ndarray | None = None) -> None:
        """Device-to-device bulk insert of already-quantized int8 rows —
        no host transit (fetch-then-re-add would move every row through
        the host twice). Builder-internal:
        assumes fresh ids (no duplicate screening). Rows at index >=
        n_valid are padding from shape-bucketed callers and never land.
        When the caller also holds the codes on host (e.g. fold_spill
        re-inserting rows whose shadow was intact), pass host_codes/
        host_scales [>= n_valid rows] to keep the write-through shadow
        valid — otherwise the shadow is invalidated and future checkpoints
        degrade to rows_skipped + SQL recovery."""
        assert self.dtype == "int8", "device insert is int8-only"
        if self.mean is None:
            # Caller-quantized rows are raw-space codes: pin a zero mean so
            # later host adds stay in the same code space (device bulk
            # loads keep today's exact semantics; centering is a host-path
            # feature). Callers inserting into an ALREADY-centered index
            # (fold paths) must quantize in that index's mean space.
            self.mean = np.zeros((self.dim,), np.float32)
        m = int(codes_dev.shape[0])
        if n_valid is None:
            n_valid = m
        assert m == len(ids) and codes_dev.shape[1] == self.dim
        rows = _bucket_rows(m)
        self._grow_to(self.count + rows + 1)
        if host_codes is not None and host_scales is not None:
            self._sh_rows[self.count : self.count + n_valid] = host_codes[:n_valid]
            self._sh_scales[self.count : self.count + n_valid] = (
                host_scales[:n_valid])
        else:
            self._sh_valid = False  # rows exist only on device now
        pad = rows - m
        qblock = jnp.pad(codes_dev, ((0, pad), (0, 0)))
        sblock = jnp.pad(scales_dev.astype(jnp.float32), ((0, pad),))
        self.buf = _write_block(self.buf, qblock, self.count, n_valid)
        self.scales = _write_block(
            self.scales[:, None], sblock[:, None], self.count, n_valid
        )[:, 0]
        if self.refine:
            # Residual codes ride along when the caller has them (fold /
            # rebuild paths moving rows within one refined index); rows
            # inserted without them keep scale 0 — reconstruction
            # degrades gracefully to the coarse code.
            if resid_dev is not None:
                rqblock = jnp.pad(resid_dev, ((0, pad), (0, 0)))
                rsblock = jnp.pad(resid_scales_dev.astype(jnp.float32),
                                  ((0, pad),))
                self.rbuf = _write_block(self.rbuf, rqblock, self.count,
                                         n_valid)
                self.rbuf_scales = _write_block(
                    self.rbuf_scales[:, None], rsblock[:, None], self.count,
                    n_valid)[:, 0]
            if host_resid is not None and host_resid_scales is not None:
                self._sh_resid[self.count : self.count + n_valid] = (
                    host_resid[:n_valid])
                self._sh_resid_scales[self.count : self.count + n_valid] = (
                    host_resid_scales[:n_valid])
        self.alive = _write_block(
            self.alive[:, None], jnp.ones((rows, 1), jnp.float32), self.count,
            n_valid,
        )[:, 0]
        for i, sid in enumerate(ids[:n_valid]):
            self._id_to_row[sid] = self.count + i
        self.ids.extend(ids[:n_valid])
        self.count += n_valid

    def delete(self, ids: list[str]) -> int:
        """Tombstone rows by id (the reference leaves this unimplemented,
        local.rs:29-32). Compacts when >25% of rows are dead."""
        if isinstance(ids, str):
            # A bare string would iterate CHARACTERS and silently no-op.
            ids = [ids]
        removed = 0
        alive = np.array(self.alive)  # writable copy
        for sid in ids:
            row = self._id_to_row.pop(sid, None)
            if row is not None and alive[row] > 0:
                alive[row] = 0.0
                self._dead_rows.add(row)
                removed += 1
        if removed:
            self.alive = jnp.asarray(alive)
            self.dead += removed
            if self.dead * 4 > max(self.count, 1):
                self.compact()
        return removed

    def delete_all(self) -> None:
        self.count = 0
        self.dead = 0
        self.ids = []
        self._id_to_row = {}
        if self.dtype == "int4":
            self.buf = jnp.zeros((self.dim // 2, self.capacity), jnp.int8)
        else:
            self.buf = jnp.zeros((self.capacity, self.dim), self._buf_dtype)
        if self.buf8 is not None:
            self.buf8 = jnp.zeros((self.capacity, self.dim), jnp.int8)
        if self.scales is not None:
            self.scales = jnp.zeros((self.capacity,), jnp.float32)
        if self.rbuf is not None:
            self.rbuf = jnp.zeros((self.capacity, self.dim), jnp.int8)
            self.rbuf_scales = jnp.zeros((self.capacity,), jnp.float32)
        self.alive = jnp.zeros((self.capacity,), jnp.float32)
        self._sh_rows = np.zeros((self.capacity, self.dim), self._sh_dtype)
        if self._sh_scales is not None:
            self._sh_scales = np.zeros((self.capacity,), np.float32)
        if self._sh_resid is not None:
            self._sh_resid = np.zeros((self.capacity, self.dim), np.int8)
            self._sh_resid_scales = np.zeros((self.capacity,), np.float32)
        self._sh_valid = True
        self._dead_rows = set()
        self.mean = None  # re-pinned at the next quantized ingestion
        # Row numbering restarts: any incremental checkpoint prefix is
        # invalid, force the next save() to rewrite from scratch.
        self._generation += 1

    def _raw_rows(self) -> np.ndarray:
        """Live-prefix rows in storage precision (int8 codes or f32), from
        the host shadow when valid — zero device bytes — else one full
        buffer fetch (device-built rows only). Full-buffer + host slice
        because a device-side `buf[:count]` compiles per fill level."""
        if self._sh_valid:
            return self._sh_rows[: self.count]
        src = self.buf8 if self.dtype == "int4" else self.buf
        return np.asarray(src)[: self.count]

    def _raw_scales(self) -> np.ndarray | None:
        if self.dtype not in ("int8", "int4"):
            return None
        if self._sh_valid:
            return self._sh_scales[: self.count]
        return np.asarray(self.scales)[: self.count]

    def _dequantized(self) -> np.ndarray:
        """Materialize live-prefix vectors as f32 (for compaction/saving).
        Mean-centered codes decode back to TRUE vectors (+mean)."""
        raw = self._raw_rows()
        scales = self._raw_scales()
        if scales is not None:
            out = raw.astype(np.float32) * scales[:, None]
        else:
            out = raw.astype(np.float32)
        if self.refine:
            # Residual codes restore ~14-bit fidelity for compaction /
            # rebuild round-trips (re-quantizing a coarse-only decode
            # would compound rounding error every cycle).
            rq, rs = self._raw_resid()
            if rq is not None:
                out = out + rq.astype(np.float32) * rs[:, None]
        if self.mean is not None and self.mean.any():
            out = out + self.mean
        return out

    def _raw_resid(self) -> tuple[np.ndarray | None, np.ndarray | None]:
        """Live-prefix residual codes + scales (refine mode), shadow-first
        like _raw_rows."""
        if not self.refine:
            return None, None
        if self._sh_valid:
            return (self._sh_resid[: self.count],
                    self._sh_resid_scales[: self.count])
        return (np.asarray(self.rbuf)[: self.count],
                np.asarray(self.rbuf_scales)[: self.count])

    def compact(self) -> None:
        """Drop tombstoned rows and repack (host-side; O(count))."""
        alive = np.asarray(self.alive)[: self.count] > 0
        keep = np.nonzero(alive)[0]
        vecs = self._dequantized()[keep]  # decoded back to RAW space
        kept_ids = [self.ids[i] for i in keep]
        # Preserve an externally pinned mean (an owning IVFIndex shares
        # its code space with this spill via `spill.mean = ivf.mean`, and
        # the spill is built center=False): delete_all() clears it, and
        # letting the re-add pin a ZERO mean would leave raw-space codes
        # that fold_spill() later scatters into the residual-space table,
        # falsely inflating their scores by ~q*mean (advisor r3, medium).
        kept_mean = self.mean
        self.delete_all()
        if kept_mean is not None and kept_mean.any():
            self.mean = kept_mean.copy()  # add() re-centers against this
        if len(kept_ids):
            self.add(vecs, kept_ids)

    # -- search ---------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[str, float]]]:
        """[Q, dim] unit queries -> per-query [(id, cosine_similarity)].

        Distance convention matches the reference's similarity output
        (local.rs:86: similarity = 1 - cosine_distance = cosine)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if self.count == 0:
            return [[] for _ in range(queries.shape[0])]
        k_eff = min(k, self.count)
        # Exact-rerank over-fetch: retrieve a wider candidate set, then
        # re-score it at HIGHEST precision.
        k_ret = (min(max(k_eff, self.rerank), self.count)
                 if self.rerank else k_eff)
        kernel = use_kernel(self.mode, k_ret,
                            "gpu" if self._interpret else None)
        vals, idx = self._device_search(queries, k_eff, k_ret, kernel)
        from ..ops.host import fetch

        # Centered codes: the scan ranked by the (rank-equivalent)
        # residual score q.delta; restore true cosines with the
        # query-constant q.mean, on host, after the device top-k.
        off = None
        if self.mean is not None and self.mean.any():
            off = queries @ self.mean
        # Tombstones are masked before the kernel's fold, so dead rows
        # never take a slot, and compaction keeps live rows >= 3/4 of
        # count: the candidate bank always holds k live rows.
        vals, idx = fetch(vals, idx)
        return self._hits_from(vals, idx, queries.shape[0], off)

    def _device_search(self, queries: np.ndarray, k: int, k_ret: int,
                       kernel: bool):
        return device_search(
            self.scan_buf, self.scales, self.alive if self.dead else None,
            self.count, jnp.asarray(queries), self.rbuf, self.rbuf_scales,
            k=k, k_ret=k_ret, kernel=kernel, mode=self.mode,
            interpret=self._interpret)

    @property
    def mode(self) -> str:
        return scan_mode(self.dtype, self.query_quantize, self.scan_precision)

    @property
    def scan_buf(self):
        """The [N, D] buffer the scan reads (int4 stores: the int8 copy)."""
        return self.buf8 if self.dtype == "int4" else self.buf

    def _hits_from(self, vals, idx, q_n: int,
                   off: np.ndarray | None = None) -> list[list[tuple[str, float]]]:
        out = []
        for qi in range(q_n):
            hits = []
            for v, r in zip(vals[qi], idx[qi]):
                if v <= -1e29 or r >= self.count:
                    continue
                hits.append((self.ids[r],
                             float(v) + (float(off[qi]) if off is not None else 0.0)))
            out.append(hits)
        return out

    # -- persistence ------------------------------------------------------------
    #
    # Format v2 (incremental): `{path}.meta.json` lists immutable row
    # segments (`{path}.seg****.****.npz`, each a contiguous run of rows in
    # STORAGE precision — int8 codes + scales, not dequantized f32 — plus
    # their ids) and the ids tombstoned since the last full rewrite. A
    # checkpoint after a k-row ingest appends one k-row segment; only a
    # compaction/clear (generation bump) rewrites from scratch. Rows come
    # from the host shadow, so serving-path checkpoints transfer zero
    # device bytes (vectors are also durable in SQL — SURVEY.md §5 — so
    # this is a warm-start optimization, not the source of truth).

    def _seg_path(self, path: str, name: str) -> str:
        return os.path.join(os.path.dirname(path) or ".", name)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not self._sh_valid and os.environ.get("MEMEX_CKPT_DEVICE_BASE") != "1":
            # Device-built rows (add_quantized) have no host shadow; saving
            # them means fetching the full buffer to the host. SQL
            # is the durable source of truth, so record the skip and let
            # load() flag the index for SQL recovery instead.
            self.remove_checkpoint(path)
            meta = {"format": 2, "dim": self.dim, "dtype": self.dtype,
                    "segments": [], "dead_ids": [], "rows_skipped": True}
            if self.mean is not None:
                meta["mean"] = [float(x) for x in self.mean]
            tmp = path + ".meta.json.tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(meta, fh)
            os.replace(tmp, path + ".meta.json")
            self._ckpt_path = path
            self._segments = []
            self._saved_count = 0
            return
        full = (
            path != self._ckpt_path
            or self._generation != self._ckpt_gen
            or not os.path.exists(path + ".meta.json")
        )
        if full:
            self.remove_checkpoint(path)  # clear stale segments
            self._segments = []
            self._saved_count = 0
            self._ckpt_path = path
            self._ckpt_gen = self._generation
        if self.count > self._saved_count:
            a, b = self._saved_count, self.count
            name = (f"{os.path.basename(path)}.seg{self._ckpt_gen % 10000:04d}"
                    f".{len(self._segments):04d}.npz")
            arrs: dict[str, np.ndarray] = {"ids": np.asarray(self.ids[a:b])}
            rows = self._raw_rows()[a:b]
            scales = self._raw_scales()
            if scales is not None:
                arrs["codes"] = rows
                arrs["scales"] = scales[a:b]
            else:
                arrs["vectors"] = rows.astype(np.float32)
            if self.refine:
                rq, rs = self._raw_resid()
                arrs["rcodes"] = rq[a:b]
                arrs["rscales"] = rs[a:b]
            np.savez(self._seg_path(path, name), **arrs)
            self._segments.append(name)
            self._saved_count = b
        meta = {
            "format": 2,
            "dim": self.dim,
            "dtype": self.dtype,
            "refine": self.refine,
            "segments": self._segments,
            "dead_rows": sorted(self._dead_rows),
        }
        if self.mean is not None:
            # Segments hold centered codes; future adds and corrections
            # must keep using exactly this mean (a pinned ZERO mean is
            # also recorded: presence means "pinned", so a reload never
            # re-pins a different center over existing codes).
            meta["mean"] = [float(x) for x in self.mean]
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(meta, fh)
        os.replace(tmp, path + ".meta.json")  # atomic vs crash mid-write

    def _install_prequantized(self, codes: np.ndarray, scales: np.ndarray,
                              ids: list[str],
                              rcodes: np.ndarray | None = None,
                              rscales: np.ndarray | None = None) -> None:
        """Bulk insert of already-int8-quantized rows (checkpoint restore):
        skips the quantization pass and keeps the exact stored codes. int4
        mode re-derives the packed nibbles from the int8 codes (coarse
        codes can shift one level vs the original f32 quantization; the
        exact int8 rerank is unaffected)."""
        assert self.dtype in ("int8", "int4")
        m = codes.shape[0]
        if m == 0:
            return
        rows = _bucket_rows(m)
        self._grow_to(self.count + rows + 1)
        self._sh_rows[self.count : self.count + m] = codes
        self._sh_scales[self.count : self.count + m] = scales
        qblock = np.zeros((rows, self.dim), np.int8)
        qblock[:m] = codes
        sblock = np.zeros((rows,), np.float32)
        sblock[:m] = scales
        if self.dtype == "int4":
            c4 = np.clip(np.round(codes.astype(np.float32) * (7.0 / 127.0)),
                         -7, 7).astype(np.int32)
            lo, hi = c4[:, : self.dim // 2], c4[:, self.dim // 2 :]
            pblock = np.zeros((self.dim // 2, rows), np.int8)
            pblock[:, :m] = (lo + 16 * hi).astype(np.int8).T
            self.buf = _write_block_cols(self.buf, jnp.asarray(pblock), self.count, m)
            self.buf8 = _write_block(self.buf8, jnp.asarray(qblock), self.count, m)
        else:
            self.buf = _write_block(self.buf, jnp.asarray(qblock), self.count, m)
        self.scales = _write_block(
            self.scales[:, None], jnp.asarray(sblock)[:, None], self.count, m
        )[:, 0]
        if self.refine and rcodes is not None:
            self._sh_resid[self.count : self.count + m] = rcodes
            self._sh_resid_scales[self.count : self.count + m] = rscales
            rqblock = np.zeros((rows, self.dim), np.int8)
            rqblock[:m] = rcodes
            rsblock = np.zeros((rows,), np.float32)
            rsblock[:m] = rscales
            self.rbuf = _write_block(
                self.rbuf, jnp.asarray(rqblock), self.count, m)
            self.rbuf_scales = _write_block(
                self.rbuf_scales[:, None], jnp.asarray(rsblock)[:, None],
                self.count, m)[:, 0]
        ones = np.zeros((rows,), np.float32)
        ones[:m] = 1.0
        self.alive = _write_block(
            self.alive[:, None], jnp.asarray(ones)[:, None], self.count, m
        )[:, 0]
        for i, sid in enumerate(ids):
            self._id_to_row[sid] = self.count + i
        self.ids.extend(ids)
        self.count += m

    @classmethod
    def load(cls, path: str, **kw) -> "FlatIndex":
        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        kw.setdefault("dtype", meta.get("dtype", "float32"))
        kw.setdefault("refine", meta.get("refine", False))
        if meta.get("format") != 2:  # legacy single-npz checkpoints
            vectors = np.load(path + ".npz")["vectors"]
            idx = cls(dim=meta["dim"],
                      capacity=max(MIN_CAPACITY, len(meta["ids"]) + 1), **kw)
            if len(meta["ids"]):
                idx.add(vectors, meta["ids"])
            return idx
        dead_rows = set(meta.get("dead_rows", []))
        dead_ids = set(meta.get("dead_ids", []))  # pre-round-2 checkpoints
        ids_l, rows_l, scales_l = [], [], []
        rcodes_l, rscales_l = [], []
        base = os.path.dirname(path) or "."
        if meta.get("rows_skipped"):
            idx = cls(dim=meta["dim"], **kw)
            if "mean" in meta:
                idx.mean = np.asarray(meta["mean"], np.float32)
            idx.needs_recovery = True
            return idx
        for name in meta["segments"]:
            arrs = np.load(os.path.join(base, name))
            ids_l.append(arrs["ids"])
            if "codes" in arrs:
                rows_l.append(arrs["codes"])
                scales_l.append(arrs["scales"])
            else:
                rows_l.append(arrs["vectors"])
            if "rcodes" in arrs:
                rcodes_l.append(arrs["rcodes"])
                rscales_l.append(arrs["rscales"])
        n_total = sum(len(a) for a in ids_l)
        idx = cls(dim=meta["dim"], capacity=max(MIN_CAPACITY, n_total + 1), **kw)
        if "mean" in meta:
            # Must land BEFORE rows: stored codes are centered at exactly
            # this mean, and future adds must share it.
            idx.mean = np.asarray(meta["mean"], np.float32)
        elif n_total:
            # Pre-centering checkpoint: rows are raw — pin zero so later
            # adds can never re-center over them.
            idx.mean = np.zeros((idx.dim,), np.float32)
        if n_total:
            ids_arr = np.concatenate(ids_l)
            rows = np.concatenate(rows_l)
            if dead_rows:
                # Positional filter: segments are contiguous row runs, so
                # the concatenation index IS the row index. Kills exactly
                # the tombstoned copies; a re-added id's live row (a later
                # position) survives.
                keep = np.ones((n_total,), bool)
                keep[[r for r in dead_rows if 0 <= r < n_total]] = False
            elif dead_ids:
                keep = ~np.isin(ids_arr, sorted(dead_ids))
            else:
                keep = slice(None)
            kept_ids = [str(s) for s in ids_arr[keep]]
            if scales_l:
                has_resid = idx.refine and len(rcodes_l) == len(meta["segments"])
                idx._install_prequantized(
                    rows[keep], np.concatenate(scales_l)[keep], kept_ids,
                    rcodes=(np.concatenate(rcodes_l)[keep]
                            if has_resid else None),
                    rscales=(np.concatenate(rscales_l)[keep]
                             if has_resid else None),
                )
            elif kept_ids:
                # Float segments hold rows in STORAGE space (residuals when
                # centered): install without re-subtracting the mean so the
                # restored buffer is byte-identical to what was saved.
                kept_rows = np.asarray(rows[keep], np.float32)
                idx._grow_to(idx.count + len(kept_ids) + 1)
                for i in range(0, len(kept_ids), _ADD_CHUNK):
                    idx._add_screened(kept_rows[i : i + _ADD_CHUNK],
                                      kept_ids[i : i + _ADD_CHUNK],
                                      precentered=True)
        if not dead_rows and not dead_ids:
            # Resume the segment log in place: the next save() appends
            # instead of rewriting (row numbering matches the segments
            # exactly when nothing was dropped).
            idx._ckpt_path = path
            idx._ckpt_gen = idx._generation
            idx._segments = list(meta["segments"])
            idx._saved_count = idx.count
        return idx

    @classmethod
    def exists(cls, path: str) -> bool:
        if not os.path.exists(path + ".meta.json"):
            return False
        try:
            with open(path + ".meta.json", "r", encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return False
        if meta.get("format") == 2:
            return True
        return os.path.exists(path + ".npz")

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        """Delete every file belonging to the checkpoint at `path`
        (meta + segments + legacy npz)."""
        try:
            with open(path + ".meta.json", "r", encoding="utf-8") as fh:
                meta = json.load(fh)
            segs = meta.get("segments", [])
        except (OSError, json.JSONDecodeError):
            segs = []
        base = os.path.dirname(path) or "."
        for name in segs:
            try:
                os.remove(os.path.join(base, name))
            except FileNotFoundError:
                pass
        for suffix in (".npz", ".meta.json"):
            try:
                os.remove(path + suffix)
            except FileNotFoundError:
                pass
