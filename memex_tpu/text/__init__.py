"""Host-side text stack: tokenization, windowing, chunking.

The reference does this with HF `tokenizers` (sliding-window truncation,
lib/libmemex/src/llm/embedding.rs:154-198) and tiktoken cl100k word
budgeting (lib/libmemex/src/llm/mod.rs:76-117). This environment has zero
egress, so the tokenizer here is fully self-contained: a BERT-style
WordPiece implementation that loads an HF `vocab.txt` when available and
falls back to a deterministic built-in character vocab otherwise. Output is
fixed-shape padded id/mask arrays — the host→device contract.
"""

from .tokenizer import WordPieceTokenizer
from .segment import segment_text, split_text, count_tokens, encode_windows

__all__ = [
    "WordPieceTokenizer",
    "segment_text",
    "split_text",
    "count_tokens",
    "encode_windows",
]
