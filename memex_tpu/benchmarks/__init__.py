"""Benchmark + recall harness (BASELINE.md / BASELINE.json configs).

Reproducible measurements behind `python -m memex_tpu.benchmarks.run`:
  - recall@k of every index tier (flat f32/bf16/int8, IVF, sharded, native
    HNSW) against the exact oracle on synthetic or supplied corpora;
  - search QPS and ingest throughput on the active backend (GPU or CPU).

The reference publishes no numbers (SURVEY.md §6); this harness is how the
rebuild's claims stay honest and comparable across rounds.
"""
