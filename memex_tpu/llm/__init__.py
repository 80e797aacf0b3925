"""LLM actions layer.

Parity with the reference's llm module (lib/libmemex/src/llm/):
  - `base`: LLM protocol {chat_completion, segment_text, truncate_text},
    ChatMessage/ChatRole, errors (llm/mod.rs:11-74)
  - `openai_client`: chat-completions HTTP client with token budgeting and
    model escalation (llm/openai/mod.rs)
  - `prompter`: prompt builders for quick-question / summarize /
    json-schema extraction (llm/prompter.rs)
  - `fake`: deterministic offline LLM (enables hermetic action tests; the
    reference has no offline path — its tests are #[ignore]d, SURVEY.md §4)
  - `local`: JAX Llama-family decode on the device (replaces the reference's GGML
    C backend, llm/local/mod.rs)
"""

from .base import ChatMessage, ChatRole, LLMError, get_llm
from .prompter import json_schema_extraction, quick_question, summarize

__all__ = [
    "ChatMessage",
    "ChatRole",
    "LLMError",
    "get_llm",
    "quick_question",
    "summarize",
    "json_schema_extraction",
]
