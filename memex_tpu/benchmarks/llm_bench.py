"""Local-LLM decode throughput on the accelerator.

Measures prefill latency and decode tokens/sec for the JAX Llama stack
(llm/local/model.py) at a published model geometry with random weights —
compute cost is weight-value-independent, so these numbers transfer to
real checkpoints of the same shape. Reference comparison point: GGML q4
CPU decode, typically ~10 tok/s for 7B-class models (the reference prints
predict time via clippy, examples/clippy/src/main.rs:242).

Usage:
  python -m memex_tpu.benchmarks.llm_bench [--geometry tinyllama-1.1b]
"""

from __future__ import annotations

import argparse
import json
import time

def stream_decode_bench(cfg, params, prompt, prompt_len, key, sc, max_new,
                        *, prefill_fn=None, decode_fn=None,
                        first_chunk=4, chunk=16):
    """Timed streaming decode (one-chunk-lookahead pipeline, mirroring
    LocalLLM._stream: dispatch chunk i+1 before fetching chunk i so each
    token fetch overlaps the next chunk's compute; the first chunk is the
    4-token ramp, so first visible token = prefill + 4 tokens + one
    fetch).

    DONATION CONTRACT (r4 postmortem): decode_fn donates its carry
    argument — a carry that has been passed to decode_fn is DEAD and must
    never be passed again. The r4 harness reused one carry across both
    warmup compiles and the timed loop; XLA:CPU ignores donation so the
    hermetic suite stayed green while the device run crashed with
    use-after-donate, costing the round its entire LLM record. This
    function chains every carry exactly once; tests/test_llm.py wraps
    decode_fn with a donation tracker to enforce it hermetically.
    Reference analogue: the GGML token loop,
    /root/reference/lib/libmemex/src/llm/local/mod.rs:101-126."""
    import jax
    import numpy as np

    if prefill_fn is None or decode_fn is None:
        from ..llm.local.model import decode_chunk as _dc, prefill as _pf

        prefill_fn = prefill_fn or _pf
        decode_fn = decode_fn or _dc

    # Warm compiles, carries chained (each consumed exactly once).
    carry = prefill_fn(cfg, params, prompt, prompt_len, key, sc)
    jax.block_until_ready(carry[1])
    carry, toks, _ = decode_fn(cfg, params, carry, sc, chunk, eos_id=-1)
    jax.block_until_ready(toks)
    carry, toks, _ = decode_fn(cfg, params, carry, sc, first_chunk, eos_id=-1)
    jax.block_until_ready(toks)
    del carry  # consumed by the warmup chain; the timed run re-prefills

    # Timed prefill: a FRESH carry for the timed stream.
    t0 = time.perf_counter()
    carry = prefill_fn(cfg, params, prompt, prompt_len, key, sc)
    float(carry[1][0])
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_stream = 0
    first_tok_s = None
    pending = decode_fn(cfg, params, carry, sc, first_chunk, eos_id=-1)
    dispatched = first_chunk
    while n_stream < max_new:
        next_carry, toks, _ = pending
        if dispatched < max_new:
            pending = decode_fn(cfg, params, next_carry, sc, chunk, eos_id=-1)
            dispatched += chunk
        toks = np.asarray(toks)  # host fetch per chunk, like real streaming
        if first_tok_s is None:
            first_tok_s = time.perf_counter() - t0
        n_stream += len(toks)
    stream_s = time.perf_counter() - t0
    return {
        "prefill_s": prefill_s,
        "stream_s": stream_s,
        "n_stream": n_stream,
        "first_tok_s": first_tok_s,
    }


GEOMETRIES = {
    # TinyLlama-1.1B (hidden 2048, 22 layers, 32 heads / 4 kv, inter 5632)
    "tinyllama-1.1b": dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                           num_heads=32, num_kv_heads=4, intermediate_size=5632,
                           max_context=2048),
    # Llama-2-7B geometry (bf16 params ~13.5 GB)
    "llama-2-7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                       num_heads=32, num_kv_heads=32, intermediate_size=11008,
                       max_context=2048),
    "tiny": dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_size=256, max_context=256),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--geometry", default="tinyllama-1.1b", choices=GEOMETRIES)
    parser.add_argument("--prompt-len", type=int, default=128)
    parser.add_argument("--max-new", type=int, default=128)
    parser.add_argument("--param-dtype", default="bfloat16",
                        choices=["float32", "bfloat16", "int8"])
    args = parser.parse_args(argv)

    from ..compile_cache import enable_compile_cache

    enable_compile_cache()
    print(json.dumps(run(args.geometry, args.prompt_len, args.max_new,
                         args.param_dtype)))
    return 0


def run(geometry: str, prompt_len: int = 128, max_new: int = 128,
        param_dtype: str = "bfloat16") -> dict:
    """Batch and streaming decode numbers at one geometry, in this process."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..llm.local.model import (
        LlamaConfig, SamplerConfig, convert_params, decode_chunk, generate,
        init_params, prefill,
    )

    cfg = LlamaConfig(**GEOMETRIES[geometry])
    params = convert_params(init_params(cfg, seed=0), param_dtype)
    params = jax.device_put(params)
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    sc = SamplerConfig()
    rng = np.random.default_rng(0)
    P = prompt_len
    prompt = jnp.asarray(rng.integers(5, cfg.vocab_size, (1, P)), jnp.int32)
    key = jax.random.PRNGKey(0)

    # -- single-dispatch generation (batch path) ------------------------------
    t0 = time.perf_counter()
    toks, n_valid = generate(cfg, params, prompt, jnp.int32(P), key, sc,
                             max_new, eos_id=-1)
    jax.block_until_ready(toks)
    compile_s = time.perf_counter() - t0
    # Best-of-3: a single sample can eat a host stall.
    batch_s = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        toks, _ = generate(cfg, params, prompt, jnp.int32(P), key, sc,
                           max_new, eos_id=-1)
        float(toks[-1])
        batch_s = min(batch_s, time.perf_counter() - t0)

    # -- streaming path (prefill + chunked decode) -----------------------------
    # stream_decode_bench owns the carry lifecycle: decode_chunk DONATES
    # its carry, and the r4 harness's reuse of one crashed the stage.
    stream = stream_decode_bench(
        cfg, params, prompt, jnp.int32(P), key, sc, max_new,
        prefill_fn=prefill, decode_fn=decode_chunk)
    prefill_s = stream["prefill_s"]
    stream_s = stream["stream_s"]
    n_stream = stream["n_stream"]
    first_tok_s = stream["first_tok_s"]

    return {
        "geometry": geometry,
        "params_m": round(n_params / 1e6, 1),
        "param_dtype": param_dtype,
        "prompt_len": P,
        "max_new": max_new,
        "compile_s": round(compile_s, 1),
        "batch_tok_per_s": round(max_new / batch_s, 1),
        "prefill_ms": round(prefill_s * 1e3, 1),
        "stream_tok_per_s": round(n_stream / stream_s, 1),
        # Time to the first VISIBLE token: prefill + first chunk + fetch.
        "first_token_ms": round((prefill_s + (first_tok_s or 0.0)) * 1e3, 1),
        "backend": jax.default_backend(),
    }


if __name__ == "__main__":
    raise SystemExit(main())
