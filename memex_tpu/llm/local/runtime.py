"""LocalLLM — the LLM-protocol wrapper around the JAX Llama decoder.

Reference surface being replaced (lib/libmemex/src/llm/local/mod.rs):
  - TOML config describing model + sampler (load_from_cfg :208-258,
    schema.rs:20-105)
  - llama2 chat assembly "[INST] <<SYS>> ... [/INST]" (:145-170)
  - MAX_TOKENS = context - 512 - 100 budget (:19)
  - streaming token events (:55-137) -> on_token callback here.

Tokenizer: HF tokenizer files in the model dir when present (via
`transformers`), else a hermetic byte-level tokenizer (ids 0-255 + BOS/EOS)
so the whole stack runs with zero downloads.
"""

from __future__ import annotations

import os
import tomllib

import jax
import jax.numpy as jnp
import numpy as np

from ...log import get_logger
from ..base import ChatMessage, budget_segment, budget_truncate
from ...text.segment import count_tokens
from .model import (
    LlamaConfig,
    SamplerConfig,
    convert_params,
    decode_chunk,
    generate,
    init_params,
    load_params,
    prefill,
)

logger = get_logger(__name__)

RESPONSE_BUDGET = 512   # reference MAX_TOKENS parts (local/mod.rs:19)
PROMPT_OVERHEAD = 100
_PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048)


class ByteTokenizer:
    """Hermetic fallback: bytes -> ids (+BOS=256, EOS=257)."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
        self.bos_id = self.tok.bos_token_id or 1
        self.eos_id = self.tok.eos_token_id or 2
        self.vocab_size = self.tok.vocab_size

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: list[int]) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


def render_chat(messages: list[ChatMessage]) -> str:
    """llama2-style chat assembly (reference local/mod.rs:145-170)."""
    system = ""
    turns: list[tuple[str, str]] = []
    for m in messages:
        if m.role.value == "system":
            system = m.content
        else:
            turns.append((m.role.value, m.content))
    parts = []
    first_user = True
    for role, content in turns:
        if role == "user":
            if first_user and system:
                parts.append(f"[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{content} [/INST]")
                first_user = False
            else:
                parts.append(f"[INST] {content} [/INST]")
        else:
            parts.append(f" {content} ")
    return "".join(parts)


class LocalLLM:
    def __init__(self, cfg: LlamaConfig, params: dict, tokenizer,
                 sampler: SamplerConfig | None = None, model_name: str = "local-llama",
                 seed: int = 0):
        self.cfg = cfg
        self.params = jax.device_put(params)
        self.tokenizer = tokenizer
        self.sampler = sampler or SamplerConfig()
        self._model_name = model_name
        self._key = jax.random.PRNGKey(seed)
        self.max_tokens = cfg.max_context - RESPONSE_BUDGET - PROMPT_OVERHEAD

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_config(cls, toml_path: str) -> "LocalLLM":
        """TOML config (reference schema.rs:20-34 shape):
            [model]   path = "<hf dir>" | "tiny"   name = "..."
                      param_dtype = "bfloat16" (default) | "float32" | "int8"
            [sampler] temperature / top_k / top_p / repetition_penalty

        param_dtype is the WEIGHT STORAGE dtype: decode is weight-HBM-
        bandwidth bound, so bf16 doubles tok/s over f32 and int8 doubles
        it again (per-out-channel scales; ~GGML-q8 quality, the reference's
        own local path runs 4-bit GGML, local/mod.rs).
        """
        with open(toml_path, "rb") as fh:
            cfg_data = tomllib.load(fh)
        model = cfg_data.get("model", {})
        sam = cfg_data.get("sampler", {})
        sampler = SamplerConfig(
            temperature=float(sam.get("temperature", 0.7)),
            top_k=int(sam.get("top_k", 40)),
            top_p=float(sam.get("top_p", 0.95)),
            repetition_penalty=float(sam.get("repetition_penalty", 1.1)),
        )
        path = model.get("path", "tiny")
        name = model.get("name", os.path.basename(str(path)) or "local")
        family = model.get("type", "llama").lower()  # reference schema.rs:20-34
        if path in ("tiny", "tiny-gptj") or not os.path.isdir(path):
            if path not in ("tiny", "tiny-gptj"):
                logger.warning("model dir %s missing; using tiny hermetic model", path)
            if family == "gptj" or path == "tiny-gptj":
                return cls.tiny_gptj(sampler=sampler, model_name=name)
            return cls.tiny(sampler=sampler, model_name=name)
        # Family from TOML, or sniffed from the checkpoint's config.json.
        if family == "llama":
            import json as _json

            with open(os.path.join(path, "config.json"), encoding="utf-8") as fh:
                hf_type = _json.load(fh).get("model_type", "llama")
            if hf_type == "gptj":
                family = "gptj"
        if family == "gptj":
            from .gptj import load_params as gptj_load

            cfg, params = gptj_load(path)
        else:
            cfg, params = load_params(path)
        params = convert_params(params, str(model.get("param_dtype", "bfloat16")))
        tokenizer = (
            HFTokenizer(path)
            if os.path.exists(os.path.join(path, "tokenizer.json"))
            or os.path.exists(os.path.join(path, "tokenizer.model"))
            else ByteTokenizer()
        )
        return cls(cfg, params, tokenizer, sampler, model_name=name)

    @classmethod
    def tiny(cls, sampler: SamplerConfig | None = None, seed: int = 0,
             model_name: str = "tiny-llama") -> "LocalLLM":
        cfg = LlamaConfig.tiny(vocab_size=ByteTokenizer.vocab_size)
        return cls(cfg, init_params(cfg, seed=seed), ByteTokenizer(), sampler,
                   model_name=model_name, seed=seed)

    @classmethod
    def tiny_gptj(cls, sampler: SamplerConfig | None = None, seed: int = 0,
                  model_name: str = "tiny-gptj") -> "LocalLLM":
        from .gptj import GptJConfig, init_params as gptj_init

        cfg = GptJConfig.tiny(vocab_size=ByteTokenizer.vocab_size)
        return cls(cfg, gptj_init(cfg, seed=seed), ByteTokenizer(), sampler,
                   model_name=model_name, seed=seed)

    # -- LLM protocol ------------------------------------------------------------

    @property
    def default_model(self) -> str:
        return self._model_name

    def chat_completion(self, model: str, messages: list[ChatMessage],
                        on_token=None, max_new: int | None = None) -> str:
        prompt_text = render_chat(messages)
        ids = [self.tokenizer.bos_id] + self.tokenizer.encode(prompt_text)
        max_prompt = self.cfg.max_context - RESPONSE_BUDGET
        ids = ids[-max_prompt:]
        # bucket the prompt length to bound compile count
        bucket = next((b for b in _PROMPT_BUCKETS if len(ids) <= b and b < self.cfg.max_context),
                      max_prompt)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(ids)] = ids
        max_new = min(max_new or RESPONSE_BUDGET, self.cfg.max_context - bucket - 1)
        if max_new <= 0:
            raise ValueError("prompt fills the context window")
        self._key, sub = jax.random.split(self._key)
        if on_token is None:
            # Batch path: whole generation in ONE device dispatch.
            tokens, n_valid = generate(
                self.cfg, self.params, jnp.asarray(padded), jnp.int32(len(ids)),
                sub, self.sampler, max_new, eos_id=self.tokenizer.eos_id,
            )
            out = np.asarray(tokens)[: int(n_valid)]
        else:
            # Streaming path: scan STREAM_CHUNK tokens per dispatch; the KV
            # cache carry stays on device, tokens surface every chunk and
            # on_token fires WHILE generation continues (reference streams
            # token events the same way, local/mod.rs:101-126).
            out = self._stream(padded, len(ids), sub, max_new, on_token)
        return self.tokenizer.decode([int(t) for t in out])

    STREAM_CHUNK = 16  # steady-state tokens per dispatch (one fetch each)
    # First dispatch is short: time-to-first-visible-token = prefill +
    # first chunk + one fetch, so a 16-token first chunk buries the
    # first word under ~12 tokens of extra decode.
    # A 4-token ramp costs one extra compiled executable (chunk length is
    # a static scan bound) and one extra dispatch per stream.
    FIRST_CHUNK = 4

    def _stream(self, padded, n_ids, key, max_new, on_token) -> list[int]:
        eos = self.tokenizer.eos_id
        carry = prefill(
            self.cfg, self.params, jnp.asarray(padded), jnp.int32(n_ids),
            key, self.sampler,
        )
        out: list[int] = []
        # Incremental detokenization over a BOUNDED tail window (the
        # HF/vLLM detokenize_incrementally scheme): decoding the full
        # sequence per token is O(n^2) tokenizer work — ~2M cumulative
        # token decodes for a 2k generation on the single-core host.
        # `prefix_off` anchors the window at the last emitted token (its
        # presence gives SentencePiece the space/byte context the next
        # tokens need); `read_off` marks how many tokens have surfaced.
        # Both decodes below start at prefix_off, so any boundary artifact
        # cancels in the delta subtraction. A trailing replacement char
        # means a multi-byte sequence is still incomplete — hold it back
        # (per-id decode would garble split UTF-8 and SentencePiece
        # leading-space marks).
        prefix_off = 0
        read_off = 0
        done = False
        # One-chunk lookahead pipeline: dispatch chunk i+1 BEFORE fetching
        # chunk i's tokens. Device execution is in-order and dispatch is
        # async, so each token fetch overlaps the next chunk's compute
        # instead of stalling it. An eos inside chunk i wastes chunk i+1's
        # <=STREAM_CHUNK
        # speculative tokens — harmless, the carry is discarded.
        pending = decode_chunk(
            self.cfg, self.params, carry, self.sampler, self.FIRST_CHUNK,
            eos_id=eos,
        )
        dispatched = self.FIRST_CHUNK  # tokens covered by dispatched chunks
        while not done and len(out) < max_new:
            carry, toks, was_done = pending
            if dispatched < max_new:
                pending = decode_chunk(
                    self.cfg, self.params, carry, self.sampler,
                    self.STREAM_CHUNK, eos_id=eos,
                )
                dispatched += self.STREAM_CHUNK
            toks, wd = np.asarray(toks), np.asarray(was_done)
            for t, d in zip(toks, wd):
                if d or len(out) >= max_new:
                    done = True
                    break
                out.append(int(t))
                prefix_text = self.tokenizer.decode(out[prefix_off:read_off])
                new_text = self.tokenizer.decode(out[prefix_off:])
                if (not new_text.endswith("\ufffd")
                        and len(new_text) > len(prefix_text)):
                    on_token(new_text[len(prefix_text):])
                    prefix_off = read_off
                    read_off = len(out)
                if int(t) == eos:
                    done = True
                    break
        # Flush any held-back tail (incomplete byte sequences included).
        prefix_text = self.tokenizer.decode(out[prefix_off:read_off])
        tail = self.tokenizer.decode(out[prefix_off:])
        if len(tail) > len(prefix_text):
            on_token(tail[len(prefix_text):])
        return out

    def segment_text(self, text: str) -> tuple[list[str], str]:
        if count_tokens(text) <= self.max_tokens:
            return [text], self._model_name
        return budget_segment(text, self.max_tokens), self._model_name

    def truncate_text(self, text: str) -> tuple[str, str]:
        return budget_truncate(text, self.max_tokens), self._model_name
