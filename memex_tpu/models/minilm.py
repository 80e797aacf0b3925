"""MiniLM sentence encoder in Flax — the device-resident replacement for the
reference's libtorch sentence-transformer backend.

Reference behavior being reproduced (lib/libmemex/src/llm/embedding.rs):
  - model: sentence-transformers/all-MiniLM-L12-v2 (384-d), loaded once and
    queried with batches of token windows (embedding.rs:57-73, 98-109);
  - output: one 384-d vector per window, mean-pooled over the attention
    mask and L2-normalized (what SentenceEmbeddingsModel does internally).

Design decisions:
  - fixed-shape [B, L] int32 ids/mask in, [B, 384] float32 out — no dynamic
    shapes anywhere, so one XLA executable per (B, L) bucket;
  - matmuls run in bfloat16 (`compute_dtype`) with float32 params and
    float32 LayerNorm/softmax accumulation — tensor-core-friendly without
    accuracy loss at 384 hidden;
  - no Python control flow in the forward pass; the layer stack is a plain
    unrolled loop over 12 identical blocks (XLA folds this at trace time).

Weights load from an HF-format checkpoint dir (`model.safetensors` with
standard BERT tensor names) or initialize deterministically from a seed for
hermetic environments.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    compute_dtype: str = "bfloat16"  # matmul dtype; params stay float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "MiniLMConfig":
        import json

        path = os.path.join(model_dir, "config.json")
        with open(path, "r", encoding="utf-8") as fh:
            cfg = json.load(fh)
        return cls(
            vocab_size=cfg.get("vocab_size", 30522),
            hidden_size=cfg.get("hidden_size", 384),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            intermediate_size=cfg.get("intermediate_size", 1536),
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        )


# ---------------------------------------------------------------------------
# Parameters: a plain pytree (dict), not a framework Module — keeps the
# forward function a pure jittable fn(params, ids, mask) -> vectors, which is
# what pjit/shard_map compose with most cleanly.
# ---------------------------------------------------------------------------


def _dense_init(key, shape, scale=0.02):
    return (scale * jax.random.normal(key, shape)).astype(jnp.float32)


def init_params(cfg: MiniLMConfig, seed: int = 0) -> dict:
    """Deterministic random init (BERT-style trunc-normal approximated by
    normal*0.02). Used when no checkpoint is available (hermetic mode)."""
    key = jax.random.PRNGKey(seed)
    keys = iter(jax.random.split(key, 16 + cfg.num_layers * 16))

    def nk():
        return next(keys)

    H, I = cfg.hidden_size, cfg.intermediate_size
    params = {
        "embeddings": {
            "word": _dense_init(nk(), (cfg.vocab_size, H)),
            "position": _dense_init(nk(), (cfg.max_position_embeddings, H)),
            "token_type": _dense_init(nk(), (cfg.type_vocab_size, H)),
            "ln_scale": jnp.ones((H,), jnp.float32),
            "ln_bias": jnp.zeros((H,), jnp.float32),
        },
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "q_w": _dense_init(nk(), (H, H)),
                "q_b": jnp.zeros((H,), jnp.float32),
                "k_w": _dense_init(nk(), (H, H)),
                "k_b": jnp.zeros((H,), jnp.float32),
                "v_w": _dense_init(nk(), (H, H)),
                "v_b": jnp.zeros((H,), jnp.float32),
                "o_w": _dense_init(nk(), (H, H)),
                "o_b": jnp.zeros((H,), jnp.float32),
                "attn_ln_scale": jnp.ones((H,), jnp.float32),
                "attn_ln_bias": jnp.zeros((H,), jnp.float32),
                "ffn_in_w": _dense_init(nk(), (H, I)),
                "ffn_in_b": jnp.zeros((I,), jnp.float32),
                "ffn_out_w": _dense_init(nk(), (I, H)),
                "ffn_out_b": jnp.zeros((H,), jnp.float32),
                "ffn_ln_scale": jnp.ones((H,), jnp.float32),
                "ffn_ln_bias": jnp.zeros((H,), jnp.float32),
            }
        )
    return params


# HF BERT tensor name -> (path in our tree). Layer index substituted in.
_HF_LAYER_MAP = {
    "attention.self.query.weight": "q_w",
    "attention.self.query.bias": "q_b",
    "attention.self.key.weight": "k_w",
    "attention.self.key.bias": "k_b",
    "attention.self.value.weight": "v_w",
    "attention.self.value.bias": "v_b",
    "attention.output.dense.weight": "o_w",
    "attention.output.dense.bias": "o_b",
    "attention.output.LayerNorm.weight": "attn_ln_scale",
    "attention.output.LayerNorm.bias": "attn_ln_bias",
    "intermediate.dense.weight": "ffn_in_w",
    "intermediate.dense.bias": "ffn_in_b",
    "output.dense.weight": "ffn_out_w",
    "output.dense.bias": "ffn_out_b",
    "output.LayerNorm.weight": "ffn_ln_scale",
    "output.LayerNorm.bias": "ffn_ln_bias",
}


def load_params(model_dir: str, cfg: MiniLMConfig | None = None) -> tuple[MiniLMConfig, dict]:
    """Load HF-format BERT weights (model.safetensors) into our pytree.

    HF Linear stores weight as [out, in]; we use [in, out], so dense weights
    are transposed on load.
    """
    if cfg is None:
        cfg = MiniLMConfig.from_model_dir(model_dir)
    from safetensors import safe_open

    path = os.path.join(model_dir, "model.safetensors")
    tensors: dict[str, np.ndarray] = {}
    with safe_open(path, framework="numpy") as f:
        for name in f.keys():
            tensors[name.removeprefix("bert.")] = f.get_tensor(name)

    def t(name, transpose=False):
        arr = tensors[name]
        if transpose:
            arr = arr.T
        return jnp.asarray(arr, jnp.float32)

    params = {
        "embeddings": {
            "word": t("embeddings.word_embeddings.weight"),
            "position": t("embeddings.position_embeddings.weight"),
            "token_type": t("embeddings.token_type_embeddings.weight"),
            "ln_scale": t("embeddings.LayerNorm.weight"),
            "ln_bias": t("embeddings.LayerNorm.bias"),
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        layer = {}
        for hf_name, ours in _HF_LAYER_MAP.items():
            full = f"encoder.layer.{i}.{hf_name}"
            is_dense_w = hf_name.endswith(".weight") and "LayerNorm" not in hf_name
            layer[ours] = t(full, transpose=is_dense_w)
        params["layers"].append(layer)
    return cfg, params


def save_params(model_dir: str, cfg: MiniLMConfig, params: dict,
                vocab: list[str] | None = None) -> None:
    """Export our pytree back to HF checkpoint format (model.safetensors +
    config.json [+ vocab.txt]) — the inverse of load_params, so a
    fine-tuned encoder (train/) can be served via EMBEDDING_MODEL=<dir>
    or loaded by any HF-compatible stack."""
    import json

    from safetensors.numpy import save_file

    os.makedirs(model_dir, exist_ok=True)
    tensors: dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    tensors["embeddings.word_embeddings.weight"] = np.asarray(emb["word"], np.float32)
    tensors["embeddings.position_embeddings.weight"] = np.asarray(emb["position"], np.float32)
    tensors["embeddings.token_type_embeddings.weight"] = np.asarray(emb["token_type"], np.float32)
    tensors["embeddings.LayerNorm.weight"] = np.asarray(emb["ln_scale"], np.float32)
    tensors["embeddings.LayerNorm.bias"] = np.asarray(emb["ln_bias"], np.float32)
    for i, lp in enumerate(params["layers"]):
        for hf_name, ours in _HF_LAYER_MAP.items():
            arr = np.asarray(lp[ours], np.float32)
            if hf_name.endswith(".weight") and "LayerNorm" not in hf_name:
                # back to HF [out, in]; safetensors serializes raw buffers,
                # so the transposed VIEW must be materialized contiguous
                arr = np.ascontiguousarray(arr.T)
            tensors[f"encoder.layer.{i}.{hf_name}"] = arr
    save_file(tensors, os.path.join(model_dir, "model.safetensors"))
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as fh:
        json.dump({
            "model_type": "bert",
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "type_vocab_size": cfg.type_vocab_size,
            "layer_norm_eps": cfg.layer_norm_eps,
            "hidden_act": "gelu",
        }, fh)
    if vocab is not None:
        with open(os.path.join(model_dir, "vocab.txt"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(vocab) + "\n")


def cast_params_to_compute(params: dict, cfg: MiniLMConfig) -> dict:
    """Store dense weights in the compute dtype (bf16) so each forward
    reads half the bytes; LayerNorm params and embeddings stay f32 (LN runs
    in f32; embedding gathers are cheap and accuracy-sensitive)."""
    cdt = jnp.dtype(cfg.compute_dtype)
    if cdt == jnp.float32:
        return params
    out = {"embeddings": params["embeddings"], "layers": []}
    for lp in params["layers"]:
        cast = {}
        for name, arr in lp.items():
            cast[name] = arr if "ln_" in name else arr.astype(cdt)
        out["layers"].append(cast)
    return out


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps):
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * scale + bias


class MiniLMEncoder:
    """Pure-function encoder: `apply(params, ids, mask) -> [B, H] unit vectors`.

    Not a framework Module by design — the apply fn is closed over only the
    static config, so `jax.jit(encoder.apply)` / `shard_map` wrap it directly.
    """

    def __init__(self, cfg: MiniLMConfig):
        self.cfg = cfg

    def hidden_states(self, params: dict, ids: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        """[B, L] ids/mask -> [B, L, H] final hidden states (float32)."""
        cfg = self.cfg
        cdt = jnp.dtype(cfg.compute_dtype)
        B, L = ids.shape
        emb = params["embeddings"]

        pos_ids = jnp.arange(L, dtype=jnp.int32)[None, :]
        x = (
            jnp.take(emb["word"], ids, axis=0)
            + jnp.take(emb["position"], pos_ids, axis=0)
            + emb["token_type"][0][None, None, :]
        )
        # Residual stream lives in the COMPUTE dtype (r5): LayerNorm math
        # stays f32 internally and residual adds accumulate in f32, but
        # the [B, L, H] stream between ops is bf16 — halving the memory
        # traffic of every LN/residual round-trip. Final unit vectors
        # agree with the f32-stream forward to mean cos 1.000000 / max abs
        # 2.4e-4 (well inside the golden-parity bar).
        # When compute_dtype=float32 the casts are no-ops (bit-identical).
        x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"],
                        cfg.layer_norm_eps).astype(cdt)

        nh, hd = cfg.num_heads, cfg.head_dim
        # Boolean key mask for jax.nn.dot_product_attention (XLA's fused
        # attention path, numerically equivalent to einsum+softmax under
        # --xla_allow_excess_precision). Its speed at head_dim 32 on the
        # GPU is not measured yet (ROADMAP S5).
        key_mask = mask.astype(bool)[:, None, None, :]

        for lp in params["layers"]:
            q = (x @ lp["q_w"].astype(cdt) + lp["q_b"].astype(cdt)).reshape(B, L, nh, hd)
            k = (x @ lp["k_w"].astype(cdt) + lp["k_b"].astype(cdt)).reshape(B, L, nh, hd)
            v = (x @ lp["v_w"].astype(cdt) + lp["v_b"].astype(cdt)).reshape(B, L, nh, hd)
            ctx = jax.nn.dot_product_attention(q, k, v, mask=key_mask)
            ctx = ctx.reshape(B, L, nh * hd).astype(cdt)
            attn_out = ctx @ lp["o_w"].astype(cdt) + lp["o_b"].astype(cdt)
            x = _layer_norm(
                x.astype(jnp.float32) + attn_out.astype(jnp.float32),
                lp["attn_ln_scale"], lp["attn_ln_bias"], cfg.layer_norm_eps,
            ).astype(cdt)

            h = x @ lp["ffn_in_w"].astype(cdt) + lp["ffn_in_b"].astype(cdt)
            h = jax.nn.gelu(h.astype(jnp.float32), approximate=False).astype(cdt)
            ffn_out = h @ lp["ffn_out_w"].astype(cdt) + lp["ffn_out_b"].astype(cdt)
            x = _layer_norm(
                x.astype(jnp.float32) + ffn_out.astype(jnp.float32),
                lp["ffn_ln_scale"], lp["ffn_ln_bias"], cfg.layer_norm_eps,
            ).astype(cdt)
        return x.astype(jnp.float32)

    def apply(self, params: dict, ids: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        """[B, L] -> [B, H] mean-pooled, L2-normalized sentence embeddings
        (sentence-transformers pooling semantics)."""
        x = self.hidden_states(params, ids, mask)
        m = mask.astype(jnp.float32)[:, :, None]
        pooled = jnp.sum(x * m, axis=1) / jnp.maximum(jnp.sum(m, axis=1), 1e-9)
        return pooled / jnp.maximum(jnp.linalg.norm(pooled, axis=-1, keepdims=True), 1e-12)
