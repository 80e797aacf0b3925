"""Llama-family decoder as a pure pytree + jittable functions.

Device-resident decode design (contrast: the reference's GGML token loop is a
C-side CPU loop driven one token at a time, llm/local/mod.rs:101-126):

  - prefill: one forward over the [1, P] padded prompt, filling the
    [L, 2, maxlen, n_kv, hd] KV cache in a single fused pass;
  - generate: `lax.scan` over decode steps inside ONE jit — each step is a
    [1, 1] forward reading the cache at static shapes, so the whole
    generation is a single XLA dispatch (no host round-trip per token);
  - GQA attention, RoPE, RMSNorm, SwiGLU — standard Llama blocks, bf16
    matmuls with f32 softmax/norms.

Weights load from HF-format safetensors (model.safetensors, llama naming)
or init randomly from a config for hermetic use.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_context: int = 2048      # reference local context 2048 (schema.rs:26-34)
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LlamaConfig":
        """Hermetic test/config-free model."""
        return cls(
            vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=256, max_context=256,
            compute_dtype="float32",
        )

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "LlamaConfig":
        with open(os.path.join(model_dir, "config.json"), "r", encoding="utf-8") as fh:
            cfg = json.load(fh)
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            intermediate_size=cfg["intermediate_size"],
            max_context=min(cfg.get("max_position_embeddings", 2048), 4096),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_eps=cfg.get("rms_norm_eps", 1e-5),
        )


def init_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Params use a LAYER-STACKED layout: every per-layer weight is one
    [L, ...] array, so the forward pass is a `lax.scan` over layers — one
    tight XLA loop instead of num_layers unrolled op groups (per-op
    dispatch overhead dominated single-token decode at 22 layers)."""
    key = jax.random.PRNGKey(seed)
    L = cfg.num_layers
    n = 4 + L * 7
    keys = iter(jax.random.split(key, n))
    H, I, KV = cfg.hidden_size, cfg.intermediate_size, cfg.num_kv_heads * cfg.head_dim

    def w(shape):
        return (0.02 * jax.random.normal(next(keys), shape)).astype(jnp.float32)

    def lw(shape):
        return jnp.stack([w(shape) for _ in range(L)])

    return {
        "embed": w((cfg.vocab_size, H)),
        "final_norm": jnp.ones((H,), jnp.float32),
        "lm_head": w((H, cfg.vocab_size)),
        "layers": {
            "attn_norm": jnp.ones((L, H), jnp.float32),
            "q": lw((H, H)),
            "k": lw((H, KV)),
            "v": lw((H, KV)),
            "o": lw((H, H)),
            "ffn_norm": jnp.ones((L, H), jnp.float32),
            "gate": lw((H, I)),
            "up": lw((H, I)),
            "down": lw((I, H)),
        },
    }


def load_params(model_dir: str, cfg: LlamaConfig | None = None) -> tuple[LlamaConfig, dict]:
    """Load HF llama safetensors ([out,in] weights -> transposed)."""
    if cfg is None:
        cfg = LlamaConfig.from_model_dir(model_dir)
    from safetensors import safe_open

    tensors: dict[str, np.ndarray] = {}
    # support sharded checkpoints via index file
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    files = ["model.safetensors"]
    if os.path.exists(index_path):
        with open(index_path) as fh:
            files = sorted(set(json.load(fh)["weight_map"].values()))
    for fname in files:
        with safe_open(os.path.join(model_dir, fname), framework="numpy") as f:
            for name in f.keys():
                tensors[name] = f.get_tensor(name)

    def t(name, transpose=True):
        arr = tensors[name]
        if transpose:
            arr = arr.T
        return jnp.asarray(arr, jnp.float32)

    _HF = {
        "attn_norm": ("input_layernorm.weight", False),
        "q": ("self_attn.q_proj.weight", True),
        "k": ("self_attn.k_proj.weight", True),
        "v": ("self_attn.v_proj.weight", True),
        "o": ("self_attn.o_proj.weight", True),
        "ffn_norm": ("post_attention_layernorm.weight", False),
        "gate": ("mlp.gate_proj.weight", True),
        "up": ("mlp.up_proj.weight", True),
        "down": ("mlp.down_proj.weight", True),
    }
    layers = {
        ours: jnp.stack([
            t(f"model.layers.{i}.{hf}", transpose=tr)
            for i in range(cfg.num_layers)
        ])
        for ours, (hf, tr) in _HF.items()
    }
    params = {
        "embed": t("model.embed_tokens.weight", transpose=False),
        "final_norm": t("model.norm.weight", transpose=False),
        "lm_head": (
            t("lm_head.weight") if "lm_head.weight" in tensors
            else t("model.embed_tokens.weight", transpose=False).T
        ),
        "layers": layers,
    }
    return cfg, params


# ---------------------------------------------------------------------------
# weight storage dtypes. Single-token decode reads every weight once per
# token, so tok/s is weight-bandwidth bound: bf16 storage halves
# bytes/token, int8 halves again using
# per-out-channel symmetric scales folded in AFTER each dot (same math as
# dequantize-then-matmul, but the bf16 weight matrix is never materialized
# in HBM — the int8->bf16 convert fuses into the matmul operand stream).
# ---------------------------------------------------------------------------

# Keys that are matmul weights (either family); everything else — norms,
# biases — stays f32 (negligible bytes, and norm scales want full precision).
_MATMUL_KEYS = frozenset(
    {"q", "k", "v", "o", "gate", "up", "down",       # llama layers
     "fc_in", "fc_out",                               # gptj layers
     "lm_head"}
)


def _quant_cols(w):
    """[..., in, out] weight -> int8 codes + per-out-channel f32 scales."""
    a = jnp.max(jnp.abs(w), axis=-2)
    s = jnp.maximum(a, 1e-8) / 127.0
    q = jnp.clip(jnp.round(w / s[..., None, :]), -127, 127).astype(jnp.int8)
    return {"q": q, "s": s.astype(jnp.float32)}


def convert_params(params: dict, dtype: str = "bfloat16") -> dict:
    """Convert matmul weights to a serving storage dtype.

    dtype: "float32" (no-op), "bfloat16" (default for serving), or "int8"
    (per-out-channel symmetric; embed per-row). The forward pass accepts
    any mix — quantized leaves are dicts {"q","s"} handled by _mm.
    """
    if dtype in ("float32", "f32"):
        return params
    if dtype in ("bfloat16", "bf16"):
        def conv(path, a):
            key = path[-1].key if path else ""
            if key in _MATMUL_KEYS or key == "embed":
                return a.astype(jnp.bfloat16)
            return a

        return jax.tree_util.tree_map_with_path(conv, params)
    if dtype != "int8":
        raise ValueError(f"unsupported param dtype {dtype!r}")
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {
                lk: (_quant_cols(lv) if lk in _MATMUL_KEYS else lv)
                for lk, lv in v.items()
            }
        elif k in _MATMUL_KEYS:
            out[k] = _quant_cols(v)
        elif k == "embed":
            a = jnp.max(jnp.abs(v), axis=-1)     # per-row: embed is a gather
            s = jnp.maximum(a, 1e-8) / 127.0
            out[k] = {
                "q": jnp.clip(jnp.round(v / s[:, None]), -127, 127).astype(jnp.int8),
                "s": s.astype(jnp.float32),
            }
        else:
            out[k] = v
    return out


def _mm(h, w, cdt):
    """h @ w for a plain array or an int8 dict {"q","s"}; scales applied
    after the dot (per-out-channel), activations stay in cdt."""
    if isinstance(w, dict):
        y = h @ w["q"].astype(cdt)
        return (y.astype(jnp.float32) * w["s"]).astype(cdt)
    return h @ w.astype(cdt)


def _embed_lookup(embed, tokens):
    """Token embedding gather -> f32 residual stream, any storage dtype."""
    if isinstance(embed, dict):
        x = jnp.take(embed["q"], tokens, axis=0).astype(jnp.float32)
        return x * jnp.take(embed["s"], tokens, axis=0)[..., None]
    return jnp.take(embed, tokens, axis=0).astype(jnp.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _rms_norm(x, scale, eps):
    x = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(var + eps) * scale


def _rope(x, positions, theta):
    """x: [B, T, n, hd]; positions: [B, T]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (jnp.arange(0, half, dtype=jnp.float32) / half))
    angles = positions[..., None].astype(jnp.float32) * freqs  # [B, T, half]
    cos = jnp.cos(angles)[:, :, None, :]
    sin = jnp.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)


def init_cache(cfg: LlamaConfig, batch: int = 1) -> dict:
    hd = cfg.head_dim
    shape = (cfg.num_layers, batch, cfg.max_context, cfg.num_kv_heads, hd)
    return {
        "k": jnp.zeros(shape, jnp.bfloat16),
        "v": jnp.zeros(shape, jnp.bfloat16),
    }


def forward(cfg: LlamaConfig, params: dict, tokens: jnp.ndarray,
            positions: jnp.ndarray, cache: dict, cache_len) -> tuple[jnp.ndarray, dict]:
    """tokens [B, T] + cache up to cache_len -> (logits [B, T, V], cache').

    Causal within the new tokens; full attention to cached positions
    < cache_len. Static shapes: cache is max_context long, masked by index.
    """
    cdt = jnp.dtype(cfg.compute_dtype)
    B, T = tokens.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = nh // nkv
    prefill_local = T > 1
    x = _embed_lookup(params["embed"], tokens)  # residual stream f32

    def layer(x, per):
        # One transformer block; scanned over the stacked layer axis so the
        # whole stack is ONE fused XLA loop (at 22 layers the unrolled
        # version's per-op dispatch overhead dominated 1-token decode).
        lp, ck_in, cv_in = per  # weights for this layer; cache [B, C, nkv, hd]
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps).astype(cdt)
        q = _mm(h, lp["q"], cdt).reshape(B, T, nh, hd)
        k = _mm(h, lp["k"], cdt).reshape(B, T, nkv, hd)
        v = _mm(h, lp["v"], cdt).reshape(B, T, nkv, hd)
        q = _rope(q.astype(jnp.float32), positions, cfg.rope_theta).astype(cdt)
        k = _rope(k.astype(jnp.float32), positions, cfg.rope_theta).astype(cdt)

        # Write new K/V into the cache at [cache_len, cache_len+T).
        ck = jax.lax.dynamic_update_slice(
            ck_in, k.astype(jnp.bfloat16), (0, cache_len, 0, 0)
        )
        cv = jax.lax.dynamic_update_slice(
            cv_in, v.astype(jnp.bfloat16), (0, cache_len, 0, 0)
        )

        # GQA as grouped einsums: query heads reshaped [nkv, rep] contract
        # directly against K/V (no materialized head repetition).
        qg = q.reshape(B, T, nkv, rep, hd)
        if prefill_local:
            # Prefill (cache empty by construction — generate()/prefill()
            # only pass T>1 at cache_len=0): attend over the new tokens
            # only, causal — cost scales with the prompt bucket, not the
            # context window. Keys round-trip through the cache dtype so
            # prefill logits match the cached-decode path bit-for-bit.
            keys = k.astype(jnp.bfloat16).astype(cdt)
            vals_ = v.astype(jnp.bfloat16).astype(cdt)
            kpos = positions[:, None, None, None, :]     # [B,1,1,1,T]
        else:
            keys, vals_ = ck.astype(cdt), cv.astype(cdt)  # [B, C, nkv, hd]
            kpos = jnp.arange(cfg.max_context)[None, None, None, None, :]
        scores = jnp.einsum("bqgrd,bkgd->bgrqk", qg, keys,
                            preferred_element_type=jnp.float32)
        scores = scores / np.sqrt(hd)
        # mask: key position must be <= query position (causal)
        qpos = positions[:, None, None, :, None]  # [B, 1, 1, T, 1]
        scores = jnp.where(kpos <= qpos, scores, -1e30)
        probs = jax.nn.softmax(scores, axis=-1).astype(cdt)
        ctx = jnp.einsum("bgrqk,bkgd->bqgrd", probs, vals_,
                         preferred_element_type=jnp.float32)
        attn_out = _mm(ctx.reshape(B, T, nh * hd).astype(cdt), lp["o"], cdt)
        x = x + attn_out.astype(jnp.float32)

        h = _rms_norm(x, lp["ffn_norm"], cfg.rms_eps).astype(cdt)
        gate = jax.nn.silu(_mm(h, lp["gate"], cdt).astype(jnp.float32)).astype(cdt)
        up = _mm(h, lp["up"], cdt)
        ffn = _mm(gate * up, lp["down"], cdt)
        x = x + ffn.astype(jnp.float32)
        return x, (ck, cv)

    x, (new_k, new_v) = jax.lax.scan(
        layer, x, (params["layers"], cache["k"], cache["v"])
    )
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _mm(x.astype(cdt), params["lm_head"], cdt)
    return logits.astype(jnp.float32), {"k": new_k, "v": new_v}


# ---------------------------------------------------------------------------
# sampling (reference sampler chain: schema.rs:36-82 — repetition penalty,
# top-k, top-p, temperature)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.95
    repetition_penalty: float = 1.1
    repetition_window: int = 64


def sample_token(logits: jnp.ndarray, recent: jnp.ndarray, key, sc: SamplerConfig):
    """logits [V]; recent [W] token ids (pad with -1) -> sampled id."""
    v = logits.shape[-1]
    # repetition penalty on recent tokens
    onehot = jnp.zeros((v,), jnp.float32)
    valid = recent >= 0
    onehot = onehot.at[jnp.clip(recent, 0, v - 1)].add(valid.astype(jnp.float32))
    seen = onehot > 0
    penalized = jnp.where(
        logits > 0, logits / sc.repetition_penalty, logits * sc.repetition_penalty
    )
    logits = jnp.where(seen, penalized, logits)

    if sc.temperature <= 0:
        return jnp.argmax(logits).astype(jnp.int32)
    logits = logits / sc.temperature
    if 0 < sc.top_k < v:
        # One top_k over the vocab; top-p then runs WITHIN the k candidates
        # (exact chain parity — the reference applies top_k before top_p,
        # schema.rs:36-82 — and the sort/cumsum shrinks from V to k, which
        # was the decode step's hidden cost: a 32k-wide sort per token).
        vals, idxs = jax.lax.top_k(logits, sc.top_k)   # vals sorted desc
        if sc.top_p < 1.0:
            probs = jax.nn.softmax(vals)
            cum = jnp.cumsum(probs)
            keep = (cum - probs) < sc.top_p            # first token always kept
            vals = jnp.where(keep, vals, -1e30)
        choice = jax.random.categorical(key, vals)
        return idxs[choice].astype(jnp.int32)
    # top_k disabled: full-vocab nucleus fallback
    if sc.top_p < 1.0:
        sorted_logits = jnp.sort(logits)[::-1]
        probs = jax.nn.softmax(sorted_logits)
        cum = jnp.cumsum(probs)
        cutoff_idx = jnp.sum(cum < sc.top_p)  # keep at least 1
        cutoff = sorted_logits[jnp.clip(cutoff_idx, 0, v - 1)]
        logits = jnp.where(logits < cutoff, -1e30, logits)
    return jax.random.categorical(key, logits).astype(jnp.int32)


# ---------------------------------------------------------------------------
# generation. Two shapes over the same scan step:
#   generate():     prefill + full scan in ONE dispatch (batch jobs);
#   prefill() + decode_chunk(): scan `chunk` tokens per dispatch, carry
#     (KV cache etc.) stays device-resident between dispatches — the host
#     sees tokens every chunk, giving TRUE streaming (reference parity:
#     token events over mpsc, local/mod.rs:101-126) at one fetch per chunk.
# ---------------------------------------------------------------------------


def model_forward(cfg, params: dict, tokens, positions, cache, cache_len):
    """Family dispatch: the generation machinery below drives any decoder
    exposing the (logits, cache') contract (Llama here, GPT-J in gptj.py —
    the reference's two local families, local/schema.rs model_type)."""
    if getattr(cfg, "model_family", "llama") == "gptj":
        from .gptj import forward as gptj_forward

        return gptj_forward(cfg, params, tokens, positions, cache, cache_len)
    return forward(cfg, params, tokens, positions, cache, cache_len)


def _decode_step(cfg, params: dict, sc: SamplerConfig, eos_id):
    """Scan step shared by generate() and decode_chunk()."""

    def step(carry, _):
        cache, cur_logits, recent, pos, key, done = carry
        key, sub = jax.random.split(key)
        tok = sample_token(cur_logits, recent, sub, sc)
        tok = jnp.where(done, eos_id, tok)
        new_done = done | (tok == eos_id)
        logits, cache = model_forward(
            cfg, params, tok[None, None], pos[None, None], cache, pos
        )
        recent = jnp.concatenate([recent[1:], tok[None]])
        return (cache, logits[0, 0], recent, pos + 1, key, new_done), (tok, done)

    return step


def _prefill_carry(cfg, params: dict, prompt: jnp.ndarray,
                   prompt_len, key, sc: SamplerConfig):
    B, P = prompt.shape
    cache = init_cache(cfg, batch=B)
    positions = jnp.arange(P)[None, :]
    logits, cache = model_forward(cfg, params, prompt, positions, cache, 0)
    # logits at the last real prompt token
    last = jnp.take_along_axis(logits, (prompt_len - 1)[None, None, None], axis=1)[0, 0]
    W = sc.repetition_window
    # seed recent with the tail of the prompt
    idx = jnp.arange(W)
    src = jnp.clip(prompt_len - W + idx, 0, P - 1)
    tail = prompt[0][src]
    recent0 = jnp.where(prompt_len - W + idx >= 0, tail, -1)
    return (cache, last, recent0, prompt_len, key, jnp.bool_(False))


@partial(jax.jit, static_argnames=("cfg", "sc"))
def prefill(cfg: LlamaConfig, params: dict, prompt: jnp.ndarray, prompt_len,
            key, sc: SamplerConfig):
    """One forward over the padded prompt -> device-resident decode carry."""
    return _prefill_carry(cfg, params, prompt, prompt_len, key, sc)


@partial(jax.jit, static_argnames=("cfg", "sc", "chunk"), donate_argnums=(2,))
def decode_chunk(cfg: LlamaConfig, params: dict, carry, sc: SamplerConfig,
                 chunk: int, eos_id: int = 2):
    """Advance the decode by `chunk` tokens in one dispatch; the carry
    (KV cache etc.) is donated — streaming holds one cache, not two.
    Returns (carry', tokens [chunk], was_done [chunk])."""
    step = _decode_step(cfg, params, sc, eos_id)
    carry, (tokens, was_done) = jax.lax.scan(step, carry, None, length=chunk)
    return carry, tokens, was_done


@partial(jax.jit, static_argnames=("cfg", "sc", "max_new"))
def generate(cfg: LlamaConfig, params: dict, prompt: jnp.ndarray, prompt_len,
             key, sc: SamplerConfig, max_new: int, eos_id: int = 2):
    """prompt [1, P] padded; returns (tokens [max_new], n_valid).

    One XLA dispatch for the whole generation. Early stop via done-mask
    (compute continues to max_new but output is truncated by n_valid).
    """
    carry = _prefill_carry(cfg, params, prompt, prompt_len, key, sc)
    step = _decode_step(cfg, params, sc, eos_id)
    _, (tokens, was_done) = jax.lax.scan(step, carry, None, length=max_new)
    n_valid = jnp.sum(~was_done)
    return tokens, n_valid

