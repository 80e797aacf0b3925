"""Encoder fine-tuning (no reference counterpart — the reference consumes
a frozen sentence-transformer; here the embedding model can be adapted to
the corpus on the same device mesh that serves it)."""

from .contrastive import TrainConfig, train_step, make_train_step, init_train_state
from .loop import load_train_state, save_train_state, train_encoder

__all__ = [
    "TrainConfig", "train_step", "make_train_step", "init_train_state",
    "train_encoder", "save_train_state", "load_train_state",
]
