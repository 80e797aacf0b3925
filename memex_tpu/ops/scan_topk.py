"""Fused flat score + top-k scan for NVIDIA GPUs (Pallas through Triton).

The plain path (`index/flat._search_xla`) writes a [Q, N] float32 score
matrix and reads it back for a sort-based top-k; at 1M rows that matrix
is 4·Q MB against an int8 corpus of 384 MB, and the sort dominates. This
kernel reads the corpus once per query tile and writes only candidates.

Layout of the work:
  - the grid is (query tiles, P slices of the live rows); each program
    owns one query tile [Qt, D] and one contiguous slice of rows, sized
    at run time from `count` so no program walks unfilled capacity;
  - a loop inside the program walks its slice in S-row chunks: one dot
    on the tensor cores per chunk (int8 x int8 -> int32 for `int8q`, bf16
    x bf16 -> f32 for `bf16`), then masks (`count`, `alive`) and folds the
    chunk into a register bank of S (best value, row) slots: slot j keeps
    the best row among the slice's rows congruent to j mod S;
  - each program writes its [Qt, S] bank; one `lax.top_k` over the
    [Q, P·S] candidates finishes the search.

Two true top-k rows lose one of themselves only when they fall in the
same slice AND the same slot: at P·S = 8192 candidates per query that is
about C(k,2)/8192 pairs per query (k=10: 0.5%), which the recall tests
bound. Blocks run in parallel and in no order, so nothing carries from
one program to another.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = -1e30  # masked-score sentinel shared with the XLA path (flat.py)
BANK = 8192  # P*S: candidates per query handed to the final top-k
_MIN_QT = 16  # Triton's dot needs every operand dimension >= 16
_SMEM = 200 * 1024  # of the 227 KB a block may use; the rest is headroom
MAX_K = 128  # deepest top-k the fused path serves (the rerank depth cap)


def use_kernel(mode: str, k: int, backend: str | None = None) -> bool:
    """The one place that chooses the flat scan's implementation. The
    fused kernel runs on a CUDA device for the "bf16" and "int8q" modes
    (every storage dtype but an exact f32 scan) at k <= MAX_K: on an H100
    it beat the XLA scan at every query batch measured (Q = 32, 128, 512;
    PERF.md), so the batch size does not enter. An exact scan stays on
    XLA, whose f32 product beat the kernel's IEEE dot at Q >= 128."""
    return ((backend or jax.default_backend()) == "gpu"
            and mode in ("bf16", "int8q") and k <= MAX_K)


def query_tile(q: int) -> int:
    """Rows of the query tile for a batch of q queries."""
    return min(64, max(_MIN_QT, pl.next_power_of_2(q)))


def _d_piece(d: int) -> int:
    """Width of one contraction piece: Triton blocks are powers of two, so
    D=384 is scanned as three 128-wide pieces rather than one padded 512."""
    p = 128
    while p > 16 and d % p:
        p //= 2
    return p if d % p == 0 else pl.next_power_of_2(d)


def chunk_plan(d: int, itemsize: int) -> tuple[int, int]:
    """(S rows per chunk, pipeline stages): the widest chunk whose loads
    fit shared memory twice over (so the next chunk's copy overlaps this
    chunk's dot), and as many stages, up to 3, as then fit."""
    s = 128
    while s > 16 and 2 * s * d * itemsize > _SMEM:
        s //= 2
    return s, max(1, min(3, _SMEM // (s * d * itemsize)))


def n_slices(q_tiles: int, capacity: int, s: int) -> int:
    """P: programs per query tile. Enough programs to fill the card's
    SMs (two waves of 132), no more than BANK/S banks per query (the
    final top-k's width), and no more than the capacity has chunks."""
    p = BANK // s
    while p > 1 and (p // 2) * q_tiles >= 264:
        p //= 2
    return max(1, min(p, capacity // s))


def slice_bounds(count, p: int, s: int):
    """[p + 1] int32 row bounds of the p program slices over the live
    prefix [0, count): whole S-row chunks each, the last one cut at count."""
    count = jnp.asarray(count, jnp.int32)
    per = (-(-count // p) + s - 1) // s * s
    return jnp.minimum(jnp.arange(p + 1, dtype=jnp.int32) * per, count)


def quantize_queries(queries):
    """Per-row symmetric int8 codes of f32 queries: (codes, scales)."""
    qs = jnp.maximum(jnp.max(jnp.abs(queries), axis=1), 1e-12) / 127.0
    codes = jnp.clip(jnp.round(queries / qs[:, None]), -127, 127)
    return codes.astype(jnp.int8), qs


def _kernel(bounds_ref, q_ref, qs_ref, buf_ref, *rest, mode: str,
            has_scales: bool, has_alive: bool, d: int, dp: int, s_rows: int):
    rest = list(rest)
    scales_ref = rest.pop(0) if has_scales else None
    alive_ref = rest.pop(0) if has_alive else None
    vals_ref, idx_ref = rest
    j = pl.program_id(1)
    start = bounds_ref[j]
    end = bounds_ref[j + 1]
    n_chunks = (end - start + s_rows - 1) // s_rows
    pieces = [(p0, min(dp, d - p0)) for p0 in range(0, d, dp)]
    col_mask = [None if w == dp else (jnp.arange(dp) < w)[None, :]
                for _, w in pieces]

    def load_q(p0, m):
        x = (q_ref[:, pl.ds(p0, dp)] if m is None else
             plgpu.load(q_ref.at[:, pl.ds(p0, dp)], mask=m, other=0))
        return x if mode == "int8q" else x.astype(jnp.bfloat16)

    qp = [load_q(p0, m) for (p0, _), m in zip(pieces, col_mask)]
    qt = qp[0].shape[0]
    slot = jnp.arange(s_rows, dtype=jnp.int32)

    def body(c, carry):
        best, bidx = carry
        r0 = start + c * s_rows
        acc = None
        for (p0, _), m, qx in zip(pieces, col_mask, qp):
            ref = buf_ref.at[pl.ds(r0, s_rows), pl.ds(p0, dp)]
            x = ref[...] if m is None else plgpu.load(ref, mask=m, other=0)
            if mode == "bf16":
                x = x.astype(jnp.bfloat16)
            part = pl.dot(qx, x, trans_b=True)
            acc = part if acc is None else acc + part
        s = acc.astype(jnp.float32)
        if mode == "int8q":
            s = s * qs_ref[...][:, None]
        rows = r0 + slot
        if has_scales:
            s = s * scales_ref[pl.ds(r0, s_rows)][None, :]
        ok = rows < end
        if has_alive:
            ok = ok & (alive_ref[pl.ds(r0, s_rows)] > 0)
        s = jnp.where(ok[None, :], s, NEG)
        take = s > best
        return (jnp.where(take, s, best),
                jnp.where(take, jnp.broadcast_to(rows[None, :], s.shape), bidx))

    init = (jnp.full((qt, s_rows), NEG, jnp.float32),
            jnp.zeros((qt, s_rows), jnp.int32))
    best, bidx = jax.lax.fori_loop(0, n_chunks, body, init)
    vals_ref[...] = best
    idx_ref[...] = bidx


@functools.partial(jax.jit, static_argnames=("mode", "interpret"))
def scan_candidates(buf, queries, scales, alive, count, *, mode: str,
                    interpret: bool = False):
    """Candidate bank of the fused scan: ([Q, P·S] f32, [Q, P·S] int32).

    buf [N, D] (f32, bf16 or int8 codes; N a multiple of S), queries
    [Q, D] f32, scales [N] per-row dequant scales or None, alive [N]
    (>0 = live) or None, count = live prefix length. mode: "bf16" (bf16
    inputs, f32 accumulation) or "int8q" (queries quantized per row to
    int8, int32 accumulation; buf must be int8). Empty slots score NEG."""
    n, d = buf.shape
    s_rows, stages = chunk_plan(d, buf.dtype.itemsize)
    assert n % s_rows == 0, (n, s_rows)
    assert mode in ("bf16", "int8q"), mode
    assert mode != "int8q" or buf.dtype == jnp.int8, buf.dtype
    q = queries.shape[0]
    qt = query_tile(q)
    q_pad = -(-q // qt) * qt
    queries = jnp.pad(queries.astype(jnp.float32), ((0, q_pad - q), (0, 0)))
    if mode == "int8q":
        qx, qs = quantize_queries(queries)
    else:
        qs = jnp.ones((q_pad,), jnp.float32)
        qx = queries
    p = n_slices(q_pad // qt, n, s_rows)
    args = [slice_bounds(count, p, s_rows), qx, qs, buf]
    if scales is not None:
        args.append(scales)
    if alive is not None:
        args.append(alive)
    kernel = functools.partial(
        _kernel, mode=mode, has_scales=scales is not None,
        has_alive=alive is not None, d=d, dp=_d_piece(d),
        s_rows=s_rows)
    in_specs = ([pl.BlockSpec((p + 1,), lambda i, j: (0,)),
                 pl.BlockSpec((qt, d), lambda i, j: (i, 0)),
                 pl.BlockSpec((qt,), lambda i, j: (i,)),
                 pl.BlockSpec((n, d), lambda i, j: (0, 0))]
                + [pl.BlockSpec((n,), lambda i, j: (0,))] * (len(args) - 4))
    out_spec = pl.BlockSpec((qt, s_rows), lambda i, j: (i, j))
    vals, idx = pl.pallas_call(
        kernel,
        grid=(q_pad // qt, p),
        in_specs=in_specs,
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((q_pad, p * s_rows), jnp.float32),
                   jax.ShapeDtypeStruct((q_pad, p * s_rows), jnp.int32)],
        compiler_params=plgpu.CompilerParams(
            num_warps=4 if qt <= 32 else 8, num_stages=stages),
        interpret=interpret,
        name="flat_scan_topk",
    )(*args)
    return vals[:q], idx[:q]


@functools.partial(jax.jit, static_argnames=("k", "mode", "interpret"))
def scan_topk(buf, queries, scales, alive, count, k: int, *, mode: str,
              interpret: bool = False):
    """Top-k (vals [Q,k] f32, rows [Q,k] int32) of the fused scan."""
    vals, idx = scan_candidates(buf, queries, scales, alive, count,
                                mode=mode, interpret=interpret)
    top_v, j = jax.lax.top_k(vals, k)
    return top_v, jnp.take_along_axis(idx, j, axis=1)


@functools.partial(jax.jit, static_argnames=("k", "mode"))
def reference_topk(buf, queries, scales, alive, count, k: int, *, mode: str):
    """Plain-JAX twin of `scan_topk` with the same score arithmetic and an
    exact top-k over all N rows: what the kernel's output is checked
    against (scores exactly for int8q, to bf16 summation order for bf16)."""
    q = queries.astype(jnp.float32)
    if mode == "int8q":
        qx, qs = quantize_queries(q)
        s = jax.lax.dot_general(qx, buf, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.int32)
        s = s.astype(jnp.float32) * qs[:, None]
    else:
        s = jnp.einsum("qd,nd->qn", q.astype(jnp.bfloat16),
                       buf.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    if scales is not None:
        s = s * scales[None, :]
    rows = jnp.arange(buf.shape[0])
    ok = rows < count
    if alive is not None:
        ok = ok & (alive > 0)
    return jax.lax.top_k(jnp.where(ok[None, :], s, NEG), k)
