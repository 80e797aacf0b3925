"""Recall@10 vs the reference's HNSW baseline (BASELINE.json north star).

The driver target reads ">=95% recall@10 vs HNSW reference on 1M 384-d
vectors". The reference's ANN index is hnsw_rs at M=16,
ef_construction=200, ef_search=32 (/root/reference/lib/libmemex/src/
storage/local.rs:101,76). This harness builds the repo's own native HNSW
(native/hnsw/hnsw.cpp) at exactly those parameters over a deterministic
corpus, scores it against an exact f32 oracle, and scores each device tier
against the SAME oracle on the SAME corpus+queries — "tier recall >=
HNSW recall" closes the target as written (the tier returns at least
what the reference's index would have).

The HNSW build is single-core CPU work (minutes at 1M rows), so it runs
ONCE and is cached on disk keyed by (n, dim, seed); the bench stage
reloads the graph in seconds. The corpus is host-generated (seeded
numpy mixture-of-Gaussians, same clustered geometry as the 10M bench
stage) so cache and bench regenerate identical bytes.
"""

from __future__ import annotations

import ctypes
import json
import os
import time

import numpy as np

DEFAULT_CACHE = os.path.expanduser("~/.cache/memex_hnsw")
M_REF = 16            # local.rs:101
EFC_REF = 200         # local.rs:101
EF_SEARCH_REF = 32    # local.rs:76


def make_corpus(n: int, dim: int = 384, seed: int = 1234,
                centers: int = 8192) -> np.ndarray:
    """Clustered unit corpus (mixture of Gaussians, same geometry as
    bench.bench_scale_10m: cos(point, center) ~ 0.8). Deterministic in
    (n, dim, seed) so the cached HNSW graph stays valid."""
    rng = np.random.default_rng(seed)
    ctr = rng.standard_normal((centers, dim), dtype=np.float32)
    ctr /= np.linalg.norm(ctr, axis=1, keepdims=True)
    asg = rng.integers(0, centers, size=n)
    sigma = 0.75 / (dim ** 0.5)
    v = ctr[asg] + sigma * rng.standard_normal((n, dim), dtype=np.float32)
    from ..native_lib import np_normalize_rows

    return np_normalize_rows(v)


def make_queries(q: int, dim: int = 384, seed: int = 1234,
                 centers: int = 8192) -> np.ndarray:
    """Queries from the same mixture (distinct stream from the corpus)."""
    rng = np.random.default_rng(seed)
    ctr = rng.standard_normal((centers, dim), dtype=np.float32)
    ctr /= np.linalg.norm(ctr, axis=1, keepdims=True)
    rq = np.random.default_rng(seed + 1)
    asg = rq.integers(0, centers, size=q)
    sigma = 0.75 / (dim ** 0.5)
    v = ctr[asg] + sigma * rq.standard_normal((q, dim), dtype=np.float32)
    from ..native_lib import np_normalize_rows

    return np_normalize_rows(v)


def exact_topk_host(corpus: np.ndarray, queries: np.ndarray, k: int,
                    block: int = 262144) -> np.ndarray:
    """Exact oracle on the host (blocked sgemm — ~seconds at 1M x 384 even
    on one core; keeps the oracle independent of every device tier)."""
    q = queries.shape[0]
    n = corpus.shape[0]
    vals = np.full((q, k), -np.inf, np.float32)
    idx = np.zeros((q, k), np.int64)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s = queries @ corpus[lo:hi].T                       # [q, b]
        cand = np.argpartition(-s, min(k, s.shape[1] - 1), axis=1)[:, :k]
        cv = np.take_along_axis(s, cand, axis=1)
        allv = np.concatenate([vals, cv], axis=1)
        alli = np.concatenate([idx, cand + lo], axis=1)
        keep = np.argpartition(-allv, k - 1, axis=1)[:, :k]
        vals = np.take_along_axis(allv, keep, axis=1)
        idx = np.take_along_axis(alli, keep, axis=1)
    order = np.argsort(-vals, axis=1)
    return np.take_along_axis(idx, order, axis=1)


class _NativeHnsw:
    """Thin raw-graph wrapper (no id mapping — rows ARE ids here)."""

    def __init__(self, handle, lib, dim: int):
        self._h = handle
        self.lib = lib
        self.dim = dim

    def __del__(self):
        try:
            if self._h:
                self.lib.hnsw_free(self._h)
        except Exception:
            pass

    def search(self, queries: np.ndarray, k: int,
               ef: int = EF_SEARCH_REF) -> np.ndarray:
        queries = np.ascontiguousarray(queries, np.float32)
        out = np.full((queries.shape[0], k), -1, np.int64)
        ids_buf = (ctypes.c_uint32 * k)()
        scores_buf = (ctypes.c_float * k)()
        for qi in range(queries.shape[0]):
            n = self.lib.hnsw_search(
                self._h,
                queries[qi].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                k, max(ef, k), ids_buf, scores_buf)
            for i in range(n):
                out[qi, i] = ids_buf[i]
        return out


def _cache_paths(cache_dir: str, n: int, dim: int, seed: int):
    tag = f"hnsw_m{M_REF}_efc{EFC_REF}_n{n}_d{dim}_s{seed}"
    return (os.path.join(cache_dir, tag + ".bin"),
            os.path.join(cache_dir, tag + ".json"))


def build_or_load(corpus: np.ndarray, seed: int,
                  cache_dir: str = DEFAULT_CACHE,
                  build_if_missing: bool = True,
                  log=None) -> tuple[_NativeHnsw | None, float]:
    """Load the cached reference-parameter graph for this corpus, else
    (optionally) build + cache it. Returns (graph, build_seconds) —
    build_seconds is 0.0 on a cache hit, and (None, 0.0) when missing
    and build_if_missing=False (bench stages skip rather than burn
    their budget on a single-core build)."""
    from ..native_lib import hnsw_lib

    lib = hnsw_lib()
    n, dim = corpus.shape
    bin_path, meta_path = _cache_paths(cache_dir, n, dim, seed)
    if os.path.exists(bin_path) and os.path.exists(meta_path):
        with open(meta_path, "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        # Guard against a stale cache from a different corpus stream.
        probe = float(np.sum(corpus[:64]))
        if abs(meta.get("probe", 1e30) - probe) < 1e-2:
            h = lib.hnsw_load(bin_path.encode())
            if h:
                return _NativeHnsw(h, lib, dim), 0.0
    if not build_if_missing:
        return None, 0.0
    os.makedirs(cache_dir, exist_ok=True)
    h = lib.hnsw_new(dim, M_REF, EFC_REF)
    out_rows = (ctypes.c_uint32 * min(n, 65536))()
    t0 = time.perf_counter()
    done = 0
    for lo in range(0, n, 65536):
        hi = min(lo + 65536, n)
        block = np.ascontiguousarray(corpus[lo:hi])
        lib.hnsw_add_batch(
            h, block.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hi - lo, out_rows)
        done = hi
        if log is not None:
            log(f"hnsw build {done}/{n} ({time.perf_counter() - t0:.0f}s)")
    build_s = time.perf_counter() - t0
    rc = lib.hnsw_save(h, bin_path.encode())
    if rc == 0:
        with open(meta_path, "w", encoding="utf-8") as fh:
            json.dump({"n": n, "dim": dim, "seed": seed, "m": M_REF,
                       "efc": EFC_REF, "build_s": build_s,
                       "probe": float(np.sum(corpus[:64]))}, fh)
    return _NativeHnsw(h, lib, dim), build_s


def recall_against(exact_idx: np.ndarray, got_idx: np.ndarray) -> float:
    """Mean top-k overlap of `got` vs the exact oracle rows."""
    q, k = exact_idx.shape
    return float(np.mean([
        len(set(exact_idx[i].tolist()) & set(int(x) for x in got_idx[i]
                                             if x >= 0)) / k
        for i in range(q)
    ]))
