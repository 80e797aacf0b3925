"""Compute kernels and helpers for the retrieval data plane.

The reference's scoring path is hnsw_rs graph traversal on CPU SIMD
(lib/libmemex/src/storage/local.rs:71-91). Here scoring is brute-force
MIPS/cosine on the accelerator:

- `topk`: XLA paths — exact `lax.top_k` and two-stage blockwise exact.
- `scan_topk`: a Pallas (Triton) kernel fusing the [Q,D]x[D,N] chunk
  products with a running candidate bank in registers, so the [Q,N]
  scores never reach device memory; `use_kernel` chooses it or XLA.
- `quant`: row quantization and IVF routing helpers.
"""

from .scan_topk import use_kernel
from .topk import blockwise_topk, exact_topk, score_topk

__all__ = [
    "blockwise_topk",
    "exact_topk",
    "score_topk",
    "use_kernel",
]
