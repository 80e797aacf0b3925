"""ShardedFlatIndex — corpus sharded across a device mesh axis.

The memex analogue of tensor/expert parallelism (SURVEY.md §2.3 item 2):
corpus rows are partitioned over the `shard` mesh axis; every device scores
its own [cap_per_shard, D] block against the (replicated) query batch with
FlatIndex's own device search; per-shard top-k results are merged with an
`all_gather` (SURVEY.md §2.3 item 4 — XLA collectives, which XLA hands to
NCCL on GPUs).

SPMD layout:
  buf   [P * cap, D]  sharded P("shard", None)   — one contiguous block/device
  scales[P * cap]     sharded P("shard")          — int8 mode only
  alive [P * cap]     sharded P("shard")
  counts[P]           sharded P("shard")          — per-shard fill level
  queries, outputs    replicated

Global ids: row r of shard s is global row s*cap + r; the host id table is
indexed globally. Ingest water-fills shard levels host-side and lands the
whole batch in ONE SPMD dispatch (every shard scatter-writes its own slice
at its own offset); deletes are a device-side tombstone scatter.

Storage dtype mirrors FlatIndex: float32 / bfloat16 / int8 (per-row
scales) — int8 quarters per-shard HBM scan bytes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..log import get_logger
from ..ops.quant import np_quantize_rows_int4
from ..ops.scan_topk import use_kernel
from ..parallel.collectives import merge_topk_across
from .flat import device_search, scan_mode

logger = get_logger(__name__)

# Bulk-add streaming chunk (rows). Pow2 so every chunk of a large load
# lands on one compiled write shape; a chunk's int8 block (~48MB at
# D=384) transfers while the host preps the next chunk.
_ADD_CHUNK = 1 << 17

_BUF_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
               "int8": jnp.int8, "int4": jnp.int8}


def make_search_fn(mesh: Mesh, axis: str, k: int, kernel: bool, mode: str,
                   interpret: bool = False, masked: bool = False):
    """Build the jitted SPMD search -> (vals [Q, k], global_idx [Q, k]):
    every shard runs FlatIndex's device search over its own rows (fused
    kernel or XLA scan, as `use_kernel` chose), then one all_gather
    merge. `scales` is all-ones for float tiers; int4 stores pass their
    int8 copy as the scan buffer. masked=False skips the tombstone read."""

    def local_search(buf, scales, alive, counts, queries):
        # Shapes inside shard_map are per-device: buf [cap, D], counts [1].
        kl = min(k, buf.shape[0])
        vals, idx = device_search(buf, scales, alive if masked else None,
                                  counts[0], queries, None, None, k=kl,
                                  k_ret=kl, kernel=kernel, mode=mode,
                                  interpret=interpret)
        gidx = idx + jax.lax.axis_index(axis) * buf.shape[0]
        return merge_topk_across(vals, gidx, axis, k)

    shmapped = jax.shard_map(
        local_search,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,  # outputs are replicated post-all_gather; checker can't infer
    )
    return jax.jit(shmapped)


def make_bulk_write_fn(mesh: Mesh, axis: str):
    """Build the jitted SPMD bulk write: EVERY shard receives its own
    [rows, D] slice and writes it at its own offset in one dispatch —
    loading 1M rows costs a handful of round-trips instead of ~1000
    (one per 1024-row block)."""

    def local_bulk(buf, scales, alive, block, sblock, valid, offset):
        # Row-scatter with OOB-drop: rows past this shard's valid count map
        # to an out-of-range index and vanish, so no read-modify-write of the
        # surrounding buffer is needed and offsets near capacity are safe.
        rows = block.shape[0]
        cap = buf.shape[0]
        arow = jnp.arange(rows, dtype=jnp.int32)
        idx = jnp.where(arow < valid[0], offset[0] + arow, cap + 1)
        buf = buf.at[idx].set(block, mode="drop")
        scales = scales.at[idx].set(sblock, mode="drop")
        alive = alive.at[idx].set(1.0, mode="drop")
        return buf, scales, alive

    shmapped = jax.shard_map(
        local_bulk,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(axis, None), P(axis),
                  P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis)),
    )
    return jax.jit(shmapped, donate_argnums=(0, 1, 2))


def make_bulk_write_fn_int4(mesh: Mesh, axis: str):
    """int4 variant of the SPMD bulk write: lands the transposed packed
    nibbles (column scatter), the int8 rerank copy, scales, and alive in
    one dispatch."""

    def local_bulk(buf4, buf8, scales, alive, block4, block8, sblock, valid, offset):
        rows = block8.shape[0]
        cap = buf8.shape[0]
        arow = jnp.arange(rows, dtype=jnp.int32)
        idx = jnp.where(arow < valid[0], offset[0] + arow, cap + 1)
        buf4 = buf4.at[:, idx].set(block4, mode="drop")
        buf8 = buf8.at[idx].set(block8, mode="drop")
        scales = scales.at[idx].set(sblock, mode="drop")
        alive = alive.at[idx].set(1.0, mode="drop")
        return buf4, buf8, scales, alive

    shmapped = jax.shard_map(
        local_bulk,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis, None), P(axis), P(axis),
                  P(None, axis), P(axis, None), P(axis), P(axis), P(axis)),
        out_specs=(P(None, axis), P(axis, None), P(axis), P(axis)),
    )
    return jax.jit(shmapped, donate_argnums=(0, 1, 2, 3))


def make_kill_fn(mesh: Mesh, axis: str):
    """Jitted SPMD tombstone: zero `alive` at the given GLOBAL rows without
    copying the whole mask to host (delete() previously materialized the
    full [P*cap] array per call). Rows outside a shard drop via OOB."""

    def local_kill(alive, grows):
        cap = alive.shape[0]
        shard = jax.lax.axis_index(axis)
        lo = shard * cap
        local = jnp.where((grows >= lo) & (grows < lo + cap), grows - lo, cap + 1)
        return alive.at[local].set(0.0, mode="drop")

    shmapped = jax.shard_map(
        local_kill, mesh=mesh, in_specs=(P(axis), P()), out_specs=P(axis)
    )
    return jax.jit(shmapped, donate_argnums=(0,))


class ShardedFlatIndex:
    """Mesh-sharded exact index with collective top-k merge.

    Single-device semantics identical to FlatIndex (tests assert this); at
    P shards, HBM scan bandwidth and QPS scale ~linearly with P.
    """

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        axis: str = "shard",
        capacity_per_shard: int = 2048,
        dtype: str = "float32",
        query_quantize: bool = True,
    ):
        assert dtype in _BUF_DTYPES, dtype
        self.query_quantize = query_quantize
        self.dim = dim
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        self.P = int(mesh.shape[axis])
        cap = max(1024, int(capacity_per_shard))
        self.cap = 1 << (cap - 1).bit_length()

        self._row_sharding = NamedSharding(mesh, P(axis, None))
        self._vec_sharding = NamedSharding(mesh, P(axis))
        self._col_sharding = NamedSharding(mesh, P(None, axis))
        total = self.P * self.cap
        if dtype == "int4":
            assert dim % 2 == 0, "int4 packing needs even dim"
            # Transposed packed nibbles, column-sharded ([D/2, cap]/device),
            # plus the int8 rerank copy (see index/flat.py int4 mode).
            self.buf = jax.device_put(
                jnp.zeros((dim // 2, total), jnp.int8), self._col_sharding
            )
            self.buf8 = jax.device_put(
                jnp.zeros((total, dim), jnp.int8), self._row_sharding
            )
        else:
            self.buf = jax.device_put(
                jnp.zeros((total, dim), _BUF_DTYPES[dtype]), self._row_sharding
            )
            self.buf8 = None
        self.scales = jax.device_put(jnp.ones((total,), jnp.float32), self._vec_sharding)
        self.alive = jax.device_put(jnp.zeros((total,), jnp.float32), self._vec_sharding)
        self.counts = [0] * self.P  # host-side fill levels
        self.dead = 0
        self.ids: dict[int, str] = {}  # global row -> id
        self._id_to_row: dict[str, int] = {}
        # Write-through host shadow (rows in storage precision, indexed by
        # global row): checkpoints read it instead of fetching device
        # shards back through the slow device->host path. int4 shadows the
        # int8 rerank copy. np.zeros is lazily backed by the OS, so the
        # full-capacity allocation costs only touched pages.
        self._sh_dtype = np.int8 if dtype in ("int8", "int4") else np.float32
        self._sh_rows = np.zeros((total, dim), self._sh_dtype)
        self._sh_scales = (np.ones((total,), np.float32)
                           if dtype in ("int8", "int4") else None)
        # Incremental-checkpoint state (same segment-log scheme as
        # FlatIndex.save): `_unsaved` = (global row, id) in insertion order.
        self._unsaved: list[tuple[int, str]] = []
        # Dead rows tracked by GLOBAL ROW (stable key within a generation),
        # not id: id tombstones would also kill re-added live rows at
        # restore (mirrors FlatIndex._dead_rows).
        self._dead_rows: set[int] = set()
        self._generation = 0
        self._ckpt_path: str | None = None
        self._ckpt_gen = -1
        self._segments: list[str] = []
        self._bulk_write = (make_bulk_write_fn_int4(mesh, axis) if dtype == "int4"
                            else make_bulk_write_fn(mesh, axis))
        self._kill = make_kill_fn(mesh, axis)
        self._search_cache: dict[object, object] = {}
        self._interpret = False  # tests: run the fused kernel interpreted

    @property
    def count(self) -> int:
        return len(self._id_to_row)

    def _quantize(self, block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self.dtype in ("int8", "int4"):
            from ..native_lib import np_quantize_rows_int8

            return np_quantize_rows_int8(block)  # one-pass C++ (ingest hot path)
        return block.astype(
            np.float32 if self.dtype == "float32" else jnp.bfloat16
        ), np.ones((block.shape[0],), np.float32)

    def add(self, vectors: np.ndarray, ids: list[str]) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        assert vectors.shape[0] == len(ids)
        if len(set(ids)) < len(ids):
            # Intra-batch duplicates: keep the LAST occurrence per id
            # (mirrors FlatIndex.add — the first copy would be an
            # undeletable ghost).
            last = {sid: i for i, sid in enumerate(ids)}
            pick = sorted(last.values())
            vectors = vectors[pick]
            ids = [ids[i] for i in pick]
        if any(sid in self._id_to_row for sid in ids):
            # Idempotent re-add (mirrors FlatIndex.add).
            fresh = [i for i, sid in enumerate(ids) if sid not in self._id_to_row]
            if not fresh:
                return
            vectors = vectors[fresh]
            ids = [ids[i] for i in fresh]
        if vectors.shape[0] > _ADD_CHUNK:
            # Stream large bulk loads in fixed pow2 chunks: host-side
            # quantize/prep of chunk i+1 overlaps the (async) H2D transfer
            # of chunk i, and every chunk hits ONE compiled write shape.
            # Screening already ran, so chunks see only fresh unique ids.
            for i in range(0, vectors.shape[0], _ADD_CHUNK):
                self._add_screened(vectors[i : i + _ADD_CHUNK],
                                   ids[i : i + _ADD_CHUNK])
            return
        self._add_screened(vectors, ids)

    def _add_screened(self, vectors: np.ndarray, ids: list[str]) -> None:
        m = vectors.shape[0]
        free_total = self.P * self.cap - sum(self.counts)
        if m > free_total:
            # Grow instead of the old hard RuntimeError — which could fire
            # mid-build on the sharded-IVF spill (overflow rows land AFTER
            # the new cluster table is installed) and kill ingest.
            self._grow_for(m)
        # Water-fill allocation: level shard fills, respecting capacity.
        alloc = self._waterfill(m)
        rows = 1 << max(3, (max(alloc) - 1).bit_length())  # pow2 block >= 8
        # ONE SPMD dispatch writes every shard's slice (1M rows = a few
        # dispatches, not ~1000).
        qall, sall = self._quantize(vectors)
        np_dt = np.int8 if self.dtype in ("int8", "int4") else np.float32
        blocks = np.zeros((self.P, rows, self.dim), np_dt)
        sblocks = np.ones((self.P, rows), np.float32)
        if self.dtype == "int4":
            pall, _ = np_quantize_rows_int4(vectors)  # [D/2, m] transposed
            blocks4 = np.zeros((self.P, self.dim // 2, rows), np.int8)
        cursor = 0
        for s in range(self.P):
            take = alloc[s]
            if take:
                blocks[s, :take] = qall[cursor : cursor + take]
                sblocks[s, :take] = sall[cursor : cursor + take]
                if self.dtype == "int4":
                    blocks4[s, :, :take] = pall[:, cursor : cursor + take]
                base = s * self.cap + self.counts[s]
                grows = range(base, base + take)
                sids = ids[cursor : cursor + take]
                self.ids.update(zip(grows, sids))
                self._id_to_row.update(zip(sids, grows))
                self._sh_rows[base : base + take] = qall[cursor : cursor + take]
                if self._sh_scales is not None:
                    self._sh_scales[base : base + take] = sall[cursor : cursor + take]
                self._unsaved.extend(zip(grows, sids))
                cursor += take
        dev_block = jnp.asarray(blocks.reshape(self.P * rows, self.dim))
        if self.dtype == "bfloat16":
            dev_block = dev_block.astype(jnp.bfloat16)
        sb = jax.device_put(jnp.asarray(sblocks.reshape(-1)), self._vec_sharding)
        va = jax.device_put(jnp.asarray(alloc, jnp.int32), self._vec_sharding)
        off = jax.device_put(jnp.asarray(self.counts, jnp.int32), self._vec_sharding)
        if self.dtype == "int4":
            # [P, D/2, rows] -> [D/2, P*rows] column-sharded
            b4 = jnp.asarray(
                np.concatenate(list(blocks4), axis=1)
            )
            self.buf, self.buf8, self.scales, self.alive = self._bulk_write(
                self.buf, self.buf8, self.scales, self.alive,
                jax.device_put(b4, self._col_sharding),
                jax.device_put(dev_block, self._row_sharding),
                sb, va, off,
            )
        else:
            self.buf, self.scales, self.alive = self._bulk_write(
                self.buf, self.scales, self.alive,
                jax.device_put(dev_block, self._row_sharding),
                sb, va, off,
            )
        for s in range(self.P):
            self.counts[s] += alloc[s]

    def _grow_for(self, m: int) -> None:
        """Double capacity_per_shard until `m` more rows fit: collect live
        rows from the host shadow (zero device fetch), reinitialize the
        sharded buffers at the new capacity, re-add (which also compacts
        tombstones). Global rows are renumbered, so this goes through
        delete_all's generation bump — the next checkpoint rewrites."""
        rows = sorted(self.ids.items())
        sids = [s for _, s in rows]
        vecs = self.rows_f32([g for g, _ in rows])
        new_cap = self.cap
        while self.P * new_cap - len(rows) < m:
            new_cap *= 2
        logger.info("sharded index grow %d -> %d rows/shard (%d live rows)",
                    self.cap, new_cap, len(rows))
        self.cap = new_cap
        self.delete_all()  # reinitializes every buffer at self.cap
        if sids:
            self.add(vecs, sids)

    def _waterfill(self, m: int) -> list[int]:
        """Distribute m rows to level out shard fills (capacity-bounded)."""
        alloc = [0] * self.P
        rem = m
        order = sorted(range(self.P), key=lambda s: self.counts[s])
        per = -(-(sum(self.counts) + m) // self.P)  # target level
        for s in order:
            take = min(self.cap - self.counts[s], max(0, per - self.counts[s]), rem)
            alloc[s] = take
            rem -= take
        for s in order:  # leftovers into remaining free capacity
            if rem == 0:
                break
            extra = min(self.cap - self.counts[s] - alloc[s], rem)
            alloc[s] += extra
            rem -= extra
        assert rem == 0
        return alloc

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[str, float]]]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        total = self.count
        if total == 0:
            return [[] for _ in range(queries.shape[0])]
        k_eff = min(k, total)
        counts_dev = jax.device_put(
            jnp.asarray(self.counts, jnp.int32), self._vec_sharding
        )
        scan_buf = self.buf8 if self.dtype == "int4" else self.buf
        args = (scan_buf, self.scales, self.alive, counts_dev,
                jnp.asarray(queries))
        from ..ops.host import fetch

        mode = scan_mode(self.dtype, self.query_quantize, "default")
        kernel = use_kernel(mode, k_eff, "gpu" if self._interpret else None)
        vals, idx = fetch(*self._search_fn(k_eff, kernel)(*args))
        return self._hits_from(vals, idx, queries.shape[0])

    def _search_fn(self, k_eff: int, kernel: bool):
        key = (k_eff, kernel, bool(self.dead))
        fn = self._search_cache.get(key)
        if fn is None:
            fn = make_search_fn(
                self.mesh, self.axis, k_eff, kernel,
                scan_mode(self.dtype, self.query_quantize, "default"),
                interpret=self._interpret, masked=bool(self.dead),
            )
            self._search_cache[key] = fn
        return fn

    def _hits_from(self, vals, idx, q_n: int) -> list[list[tuple[str, float]]]:
        out = []
        for qi in range(q_n):
            hits = []
            for v, r in zip(vals[qi], idx[qi]):
                sid = self.ids.get(int(r))
                if v <= -1e29 or sid is None:
                    continue
                hits.append((sid, float(v)))
            out.append(hits)
        return out

    def rows_f32(self, grows: list[int]) -> np.ndarray:
        """Materialize the given global rows as dequantized float32 from the
        host shadow (zero device bytes; int8 codes get their per-row scales
        folded back in)."""
        if not grows:
            return np.zeros((0, self.dim), np.float32)
        sel = np.asarray(grows)
        raw = self._sh_rows[sel].astype(np.float32)
        if self._sh_scales is not None:
            raw = raw * self._sh_scales[sel][:, None]
        return raw

    def delete(self, ids: list[str]) -> int:
        if isinstance(ids, str):
            ids = [ids]  # a bare string would iterate characters and no-op
        grows = []
        for sid in ids:
            row = self._id_to_row.pop(sid, None)
            if row is not None:
                self.ids.pop(row, None)
                self._dead_rows.add(row)
                grows.append(row)
        if grows:
            # Device-side tombstone scatter (no host copy of the full mask).
            rows = 1 << max(3, (len(grows) - 1).bit_length())
            sentinel = self.P * self.cap + 1  # OOB on every shard -> dropped
            padded = np.full((rows,), sentinel, np.int32)
            padded[: len(grows)] = grows
            self.alive = self._kill(self.alive, jnp.asarray(padded))
            self.dead += len(grows)
            if self.dead * 4 > max(self.count, 1):
                self.compact()
        return len(grows)

    def compact(self) -> None:
        """Repack live rows, reclaiming tombstoned capacity (host-side
        round-trip; triggered at >25% dead, mirroring FlatIndex)."""
        rows = sorted(self.ids.items())
        grows = [r for r, _ in rows]
        sids = [s for _, s in rows]
        vecs = self.rows_f32(grows)
        self.delete_all()
        if sids:
            self.add(vecs, sids)

    def delete_all(self) -> None:
        total = self.P * self.cap
        if self.dtype == "int4":
            self.buf = jax.device_put(
                jnp.zeros((self.dim // 2, total), jnp.int8), self._col_sharding
            )
            self.buf8 = jax.device_put(
                jnp.zeros((total, self.dim), jnp.int8), self._row_sharding
            )
        else:
            self.buf = jax.device_put(
                jnp.zeros((total, self.dim), _BUF_DTYPES[self.dtype]), self._row_sharding
            )
        self.scales = jax.device_put(jnp.ones((total,), jnp.float32), self._vec_sharding)
        self.alive = jax.device_put(jnp.zeros((total,), jnp.float32), self._vec_sharding)
        self.counts = [0] * self.P
        self.dead = 0
        self.ids = {}
        self._id_to_row = {}
        self._sh_rows = np.zeros((total, self.dim), self._sh_dtype)
        if self._sh_scales is not None:
            self._sh_scales = np.ones((total,), np.float32)
        self._unsaved = []
        self._dead_rows = set()
        self._generation += 1  # row numbering restarted

    # -- persistence (FlatIndex-style segment log; see index/flat.py) --------

    def save(self, path: str) -> None:
        """Incremental checkpoint from the host shadow: appends only rows
        added since the last save; a compaction/clear forces a rewrite."""
        import json as _json
        import os as _os

        _os.makedirs(_os.path.dirname(path) or ".", exist_ok=True)
        full = (
            path != self._ckpt_path
            or self._generation != self._ckpt_gen
            or not _os.path.exists(path + ".meta.json")
        )
        if full:
            self.remove_checkpoint(path)
            self._segments = []
            self._ckpt_path = path
            self._ckpt_gen = self._generation
            self._unsaved = sorted(self.ids.items())  # all live rows
            self._dead_rows = set()  # full rewrites persist live rows only
        pending = [(g, s) for g, s in self._unsaved if self.ids.get(g) == s]
        if pending:
            name = (f"{_os.path.basename(path)}.seg{self._ckpt_gen % 10000:04d}"
                    f".{len(self._segments):04d}.npz")
            grows = np.asarray([g for g, _ in pending])
            arrs: dict[str, np.ndarray] = {
                "ids": np.asarray([s for _, s in pending]),
                # Global rows: the stable per-row key dead_rows refers to
                # (restore filters tombstones positionally, so a re-added
                # id's live row is never collateral damage).
                "grows": grows.astype(np.int64),
            }
            if self._sh_scales is not None:
                arrs["codes"] = self._sh_rows[grows]
                arrs["scales"] = self._sh_scales[grows]
            else:
                arrs["vectors"] = self._sh_rows[grows].astype(np.float32)
            np.savez(_os.path.join(_os.path.dirname(path) or ".", name), **arrs)
            self._segments.append(name)
        self._unsaved = []
        meta = {
            "format": 2,
            "dim": self.dim,
            "dtype": self.dtype,
            "segments": self._segments,
            "dead_rows": sorted(int(g) for g in self._dead_rows),
        }
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            _json.dump(meta, fh)
        _os.replace(tmp, path + ".meta.json")

    def restore(self, path: str) -> int:
        """Re-add rows from a checkpoint (fresh index; rows get new global
        rows via the normal water-fill add). int8 codes round-trip exactly:
        requantizing a dequantized row reproduces the same codes+scale.
        Returns rows restored."""
        import json as _json
        import os as _os

        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = _json.load(fh)
        if meta.get("format") != 2:  # legacy single-npz
            vectors = np.load(path + ".npz")["vectors"]
            ids = meta["ids"]
            if ids:
                self.add(vectors, ids)
            return len(ids)
        dead_rows = set(meta.get("dead_rows", []))
        dead_ids = set(meta.get("dead_ids", []))  # pre-round-2 checkpoints
        base = _os.path.dirname(path) or "."
        restored = 0
        for name in meta["segments"]:
            arrs = np.load(_os.path.join(base, name))
            ids_arr = arrs["ids"]
            if "codes" in arrs:
                vecs = arrs["codes"].astype(np.float32) * arrs["scales"][:, None]
            else:
                vecs = arrs["vectors"]
            if dead_rows and "grows" in arrs:
                # Positional tombstones: filter by the saved global row,
                # so a re-added id's live row (a different grow) survives.
                keep = ~np.isin(arrs["grows"], sorted(dead_rows))
                ids_arr, vecs = ids_arr[keep], vecs[keep]
            elif dead_ids:
                keep = ~np.isin(ids_arr.astype(str), sorted(dead_ids))
                ids_arr, vecs = ids_arr[keep], vecs[keep]
            if len(ids_arr):
                self.add(vecs, [str(s) for s in ids_arr])
                restored += len(ids_arr)
        # Do NOT resume the segment log: the water-fill re-add renumbers
        # global rows, so the saved grows no longer match — a later delete
        # would record a row the old segments cannot name. The next save()
        # sees _ckpt_gen == -1 and rewrites from the host shadow (host-only
        # cost; restores are rare).
        return restored

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        from .flat import FlatIndex

        FlatIndex.remove_checkpoint(path)  # same file layout
