"""Contrastive fine-tuning of the MiniLM encoder (InfoNCE / in-batch
negatives — the standard sentence-transformers recipe).

Training step:
  - pure function `(state, batch) -> (state, metrics)` under jit;
  - data parallelism: batch sharded over the mesh, params/opt-state
    replicated, gradients averaged by XLA's psum under the hood (jit with
    sharding annotations inserts the collective);
  - bf16 forward (the encoder's compute dtype), f32 loss/optimizer.

Batch = (query_ids, query_mask, doc_ids, doc_mask): row i's positive is
doc i; all other docs in the batch are negatives.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import optax

from ..models.minilm import MiniLMConfig, MiniLMEncoder


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    temperature: float = 0.05  # InfoNCE temperature (sentence-transformers default scale)
    grad_clip: float = 1.0


def init_train_state(cfg: MiniLMConfig, params: dict, tc: TrainConfig):
    tx = make_optimizer(tc)
    return {"params": params, "opt": tx.init(params), "step": jnp.zeros((), jnp.int32)}


def make_optimizer(tc: TrainConfig):
    return optax.chain(
        optax.clip_by_global_norm(tc.grad_clip),
        optax.adamw(tc.learning_rate, weight_decay=tc.weight_decay),
    )


def info_nce_loss(q_emb: jnp.ndarray, d_emb: jnp.ndarray, temperature: float):
    """Symmetric InfoNCE over in-batch negatives. Embeddings unit-norm."""
    logits = (q_emb @ d_emb.T) / temperature  # [B, B]
    labels = jnp.arange(logits.shape[0])
    loss_qd = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    loss_dq = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
    loss = 0.5 * (loss_qd + loss_dq).mean()
    acc = jnp.mean(jnp.argmax(logits, axis=1) == labels)
    return loss, acc


def make_train_step(cfg: MiniLMConfig, tc: TrainConfig):
    """Returns jittable `(state, batch) -> (state, metrics)`."""
    encoder = MiniLMEncoder(cfg)
    tx = make_optimizer(tc)

    def loss_fn(params, batch):
        q_emb = encoder.apply(params, batch["q_ids"], batch["q_mask"])
        d_emb = encoder.apply(params, batch["d_ids"], batch["d_mask"])
        return info_nce_loss(q_emb, d_emb, tc.temperature)

    def step(state, batch):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state["params"], batch
        )
        updates, opt = tx.update(grads, state["opt"], state["params"])
        params = optax.apply_updates(state["params"], updates)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "accuracy": acc}

    return step


@partial(jax.jit, static_argnames=("cfg", "tc"))
def train_step(cfg: MiniLMConfig, tc: TrainConfig, state, batch):
    return make_train_step(cfg, tc)(state, batch)
