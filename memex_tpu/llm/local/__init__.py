"""Local LLM on the device — JAX Llama-family decode.

Replaces the reference's GGML C backend (lib/libmemex/src/llm/local/mod.rs):
same capability surface — load weights from a TOML-described config
(schema.rs:20-34), llama2 [INST]<<SYS>> chat assembly (mod.rs:145-170),
sampler chain repetition-penalty/top-k/top-p/temperature (schema.rs:36-82),
token budget MAX_TOKENS = context - 512 - 100 (mod.rs:19) — but decode is
a single jitted lax.scan over the whole generation (one XLA dispatch per
request, not one per token), with a static-shape KV cache.
"""

from .runtime import LocalLLM

__all__ = ["LocalLLM"]
