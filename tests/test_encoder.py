"""Encoder tests on a tiny MiniLM config (fast on CPU).

Mirrors the reference's hermetic unit-test style (SURVEY.md §4) plus the
multi-device additions: DP-sharded encode must equal single-device encode.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from memex_tpu.embed.engine import EmbeddingEngine
from memex_tpu.models.minilm import MiniLMConfig, MiniLMEncoder, init_params


def tiny_engine(mesh=None, **kw):
    eng = EmbeddingEngine.__new__(EmbeddingEngine)
    # Build a small engine by hand to keep tests fast.
    import threading

    from memex_tpu.text import WordPieceTokenizer

    eng.max_seq_length = kw.get("max_seq_length", 64)
    eng.window_stride = kw.get("window_stride", 16)
    eng.max_batch = kw.get("max_batch", 32)
    eng.fetch_dtype = kw.get("fetch_dtype", "float32")
    eng.mesh = mesh
    eng.data_axis = "data"
    eng._lock = threading.Lock()
    eng.tokenizer = WordPieceTokenizer()
    eng.cfg = MiniLMConfig(
        vocab_size=eng.tokenizer.vocab_size,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        intermediate_size=128,
        compute_dtype="float32",
    )
    params = init_params(eng.cfg, seed=0)
    eng.encoder = MiniLMEncoder(eng.cfg)
    eng.dim = 64
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        eng.params = jax.device_put(params, NamedSharding(mesh, P()))
        eng._in_sharding = NamedSharding(mesh, P("data", None))
        eng._out_sharding = NamedSharding(mesh, P("data", None))
        eng._n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    else:
        eng.params = jax.device_put(params)
        eng._in_sharding = None
        eng._out_sharding = None
        eng._n_dev = 1
    return eng


def test_encode_single_unit_norm():
    eng = tiny_engine()
    v = eng.encode_single("hello world, this is memex on a GPU")
    assert v.shape == (64,)
    assert abs(float(np.linalg.norm(v)) - 1.0) < 1e-4


def test_encode_document_windows():
    eng = tiny_engine()
    text = " ".join(f"word{i}" for i in range(200))
    segments, vecs = eng.encode(text)
    assert len(segments) == vecs.shape[0] > 1
    norms = np.linalg.norm(vecs, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)


def test_padding_rows_do_not_affect_results():
    eng = tiny_engine()
    texts = [f"sample text number {i}" for i in range(5)]
    batch = eng.encode_batch(texts)
    singles = np.stack([eng.encode_batch([t])[0] for t in texts])
    np.testing.assert_allclose(batch, singles, atol=1e-4)


def test_determinism():
    eng = tiny_engine()
    v1 = eng.encode_single("determinism check")
    v2 = eng.encode_single("determinism check")
    np.testing.assert_array_equal(v1, v2)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device")
def test_data_parallel_matches_single_device():
    devices = np.array(jax.devices()[:8]).reshape(8)
    mesh = Mesh(devices, ("data",))
    eng_dp = tiny_engine(mesh=mesh)
    eng_1 = tiny_engine()
    texts = [f"passage about topic {i}" for i in range(16)]
    a = eng_dp.encode_batch(texts)
    b = eng_1.encode_batch(texts)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_encode_many_matches_encode():
    engine = tiny_engine()
    texts = [
        "short one",
        "a much longer document " * 40,
        "third text with different words entirely",
    ]
    import numpy as np

    many = engine.encode_many(texts)
    for text, (segs, vecs) in zip(texts, many):
        segs1, vecs1 = tiny_engine().encode(text)  # fresh engine, same seed
        assert segs == segs1
        np.testing.assert_allclose(vecs, vecs1, atol=2e-3)


def test_fetch_dtype_f16_close_and_pipelined_chunks_ordered():
    """fetch_dtype=float16 halves the device->host bytes; vectors must
    round-trip within f16
    resolution, and the dispatch-all-then-fetch pipeline must keep chunk
    results in their original row order."""
    import numpy as np

    a = tiny_engine(max_batch=8)
    b = tiny_engine(max_batch=8, fetch_dtype="float16")
    texts = [f"pipeline order row {i} with some extra words" for i in range(37)]
    va = a.encode_batch(texts)   # 5 chunks of <=8: exercises the pipeline
    vb = b.encode_batch(texts)
    assert va.dtype == np.float32 and vb.dtype == np.float32
    # f16 cast error on unit-ish vectors; also proves rows didn't permute
    # (a swapped chunk would differ at O(1), not O(1e-3)).
    assert np.max(np.abs(va - vb)) < 2e-3
    # single-chunk path agrees with the multi-chunk pipeline
    one = tiny_engine(max_batch=64).encode_batch(texts)
    np.testing.assert_allclose(one, va, atol=1e-5)


def test_bulk_encode_matches_chunked_path():
    """r5: large ingests (> 8 x max_batch rows) take _encode_bulk
    (fixed-shape super-chunk uploads + on-device dynamic_slice). Must be
    bit-equal to the per-chunk path, including the padded tail, and must
    reuse ONE slice executable across different corpus sizes."""
    eng = tiny_engine(max_batch=8)  # bulk path at N >= 64
    texts = [f"bulk window text number {i}" for i in range(70)]
    import numpy as np

    from memex_tpu.text import encode_windows

    ids, mask = encode_windows(texts, eng.tokenizer, eng.max_seq_length)
    out_bulk = np.empty((len(texts), eng.dim), np.float32)
    phases: dict = {}
    out_bulk = eng._encode_bulk(ids, mask, out_bulk, phases=phases)
    assert set(phases) == {"dispatch_s", "device_sync_s", "fetch_s"}

    # chunked reference: force the small path by raising the threshold
    eng2 = tiny_engine(max_batch=128)  # 70 < 8*128 -> chunked
    eng2.params = eng.params  # same weights
    out_chunk = eng2._encode_padded(ids, mask)
    np.testing.assert_allclose(out_bulk, out_chunk, atol=1e-5)

    # different N, same executable (no recompile per corpus size)
    fn_before = eng._bulk_fn
    ids2, mask2 = encode_windows(texts[:65], eng.tokenizer, eng.max_seq_length)
    out2 = eng._encode_bulk(ids2, mask2,
                            np.empty((65, eng.dim), np.float32))
    assert eng._bulk_fn is fn_before
    np.testing.assert_allclose(out2, out_chunk[:65], atol=1e-5)
