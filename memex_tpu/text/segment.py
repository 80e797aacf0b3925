"""Document windowing + LLM-budget chunking.

- `segment_text`: sliding token window (max 256, stride 86 overlap), the
  embedding chunker — parity with reference ModelConfig defaults and HF
  truncation-overflow behavior (lib/libmemex/src/llm/embedding.rs:57-73,
  154-198).
- `split_text`: word-level chunker with ~10-word overlap for LLM context
  budgets (lib/libmemex/src/llm/mod.rs:76-117).
- `count_tokens`: pluggable token counter. Uses EXACT tiktoken cl100k
  when its encoding data is loadable (reference parity,
  lib/libmemex/src/llm/mod.rs:77); falls back to a calibrated heuristic
  (≈ max(words·4/3, chars/4), over-counting = budget-safe) in air-gapped
  environments where the cl100k BPE file cannot be fetched.
- `encode_windows`: the host→device contract — fixed-shape padded int32
  id/mask arrays for a batch of windows.
"""

from __future__ import annotations

import re

import numpy as np

from .tokenizer import WordPieceTokenizer

_WORD_RE = re.compile(r"\w+|[^\w\s]")

_CL100K = None  # 0 = probed and unavailable


def _cl100k():
    """tiktoken cl100k_base, probed once; loading fetches the BPE ranks
    file over the network, so air-gapped hosts land on the heuristic."""
    global _CL100K
    if _CL100K is None:
        try:
            import tiktoken

            _CL100K = tiktoken.get_encoding("cl100k_base")
        except Exception:
            _CL100K = 0
    return _CL100K or None


def count_tokens(text: str) -> int:
    """cl100k token count: exact via tiktoken when available, else a
    calibrated heuristic (GPT-style BPE averages ~4 chars or ~0.75 words
    per token on English; the max of both estimates over-counts, so
    budgets err on the safe side)."""
    if not text:
        return 0
    enc = _cl100k()
    if enc is not None:
        return len(enc.encode(text, disallowed_special=()))
    words = len(_WORD_RE.findall(text))
    return max(int(words * 4 / 3), len(text) // 4, 1)


def window_token_ids(
    ids: list[int],
    tokenizer: WordPieceTokenizer,
    max_length: int = 256,
    stride: int = 86,
) -> list[list[int]]:
    """Split raw (no-special) token ids into overlapping windows of
    max_length (including [CLS]/[SEP]), consecutive windows sharing
    `stride` tokens — HF truncation+stride semantics."""
    content = max_length - 2  # room for [CLS]/[SEP]
    if content <= 0:
        raise ValueError("max_length must exceed 2")
    if stride >= content:
        raise ValueError("stride must be smaller than max_length - 2")
    windows: list[list[int]] = []
    step = content - stride
    start = 0
    while True:
        chunk = ids[start : start + content]
        windows.append([tokenizer.cls_id] + chunk + [tokenizer.sep_id])
        if start + content >= len(ids):
            break
        start += step
    return windows


def segment_text(
    text: str,
    tokenizer: WordPieceTokenizer,
    max_length: int = 256,
    stride: int = 86,
) -> list[str]:
    """Chunk a document into overlapping windows and decode each window
    back to text (reference embedding.rs:154-198 stores decoded windows as
    the segment contents)."""
    ids = tokenizer.encode(text, add_special_tokens=False)
    if not ids:
        return [""]
    windows = window_token_ids(ids, tokenizer, max_length, stride)
    return [tokenizer.decode(w) for w in windows]


def encode_windows(
    texts: list[str],
    tokenizer: WordPieceTokenizer,
    max_length: int = 256,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of (already-windowed) texts into fixed-shape padded
    arrays: (ids[B, max_length] int32, mask[B, max_length] int32)."""
    batch = len(texts)
    ids_arr = np.full((batch, max_length), tokenizer.pad_id, dtype=np.int32)
    mask = np.zeros((batch, max_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = tokenizer.encode(text, add_special_tokens=True)[:max_length]
        # Guarantee a trailing [SEP] even when truncated.
        if len(ids) == max_length and ids[-1] != tokenizer.sep_id:
            ids[-1] = tokenizer.sep_id
        ids_arr[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1
    return ids_arr, mask


def split_text(text: str, max_tokens: int, counter=count_tokens) -> list[str]:
    """Word-level chunker with ~10-word overlap, budgeted by token counts
    (parity with reference split_text, lib/libmemex/src/llm/mod.rs:76-117)."""
    total = counter(text)
    if total <= max_tokens:
        return [text]
    split_count = total // max_tokens + 2
    split_size = len(text) // split_count if split_count else len(text)
    if split_size == 0 or split_size >= len(text):
        return [text]
    parts: list[str] = []
    part: list[str] = []
    size = 0
    for word in text.split(" "):
        if size + len(word) > split_size and part:
            parts.append(" ".join(part))
            keep = 10 if len(part) > 10 else 0
            part = part[len(part) - keep :] if keep else []
            size = len(" ".join(part))
        size += len(word) + 1
        part.append(word)
    if part:
        parts.append(" ".join(part))
    return parts
