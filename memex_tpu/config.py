"""Layered configuration: .env file -> environment -> CLI flags.

Mirrors the reference's config surface (bin/memex/src/main.rs:20-33,
.env.template) while adding device-side knobs. Connection URIs select
backends by scheme, as in the reference (lib/libmemex/src/db/mod.rs:9-28,
lib/libmemex/src/storage/mod.rs:95-139).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader (reference uses dotenv, bin/memex/src/main.rs:52).

    Does not override variables already present in the environment.
    """
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip().strip('"').strip("'")
            if key and key not in os.environ:
                os.environ[key] = value


@dataclass
class Settings:
    """Runtime settings for the service.

    Reference env vars (README.md "Env variables", .env.template):
      HOST, PORT, DATABASE_CONNECTION, VECTOR_CONNECTION, OPENAI_API_KEY,
      LOCAL_LLM_CONFIG.
    """

    host: str = "127.0.0.1"
    port: int = 8181
    db_uri: str = "sqlite://memex.db"
    vector_uri: str = "tpu://./vector_data"
    openai_api_key: str | None = None
    openai_base_url: str = "https://api.openai.com/v1"
    local_llm_config: str | None = None
    upload_dir: str = "./uploads"

    # --- device-side knobs (new in this framework) ---
    # Embedding model: HF-format checkpoint dir (config.json [+ weights]) or
    # "random" for a deterministic randomly-initialized encoder (useful in
    # hermetic environments with no model downloads).
    embedding_model: str = "random"
    embedding_dim: int = 384
    # Chunking parity with reference ModelConfig::default
    # (lib/libmemex/src/llm/embedding.rs:64-73).
    max_seq_length: int = 256
    window_stride: int = 86
    # Index
    index_capacity: int = 4096  # initial device shard capacity (doubles as needed)
    index_dtype: str = "float32"  # or "bfloat16" / "int8" for quantized shards
    # Worker loop parity (lib/worker/src/lib.rs:27-45,124).
    worker_poll_interval_s: float = 0.1
    worker_max_active: int = 5
    # New vs reference: reap tasks stuck in Processing after this lease.
    task_lease_s: float = 300.0
    # Search microbatch cap: the fused scan is HBM-bound, so per-batch time
    # is near-constant up to ~256 queries — under load a larger cap raises
    # QPS/chip ~linearly (MEMEX_SEARCH_MAX_BATCH to override).
    search_max_batch: int = 128
    # Device-index checkpoint cadence (seconds). SQL stays the source of
    # truth; checkpoints only warm-start restarts, so they are rate-limited
    # instead of per-ingest (vs reference local.rs:62-69 save-per-insert).
    checkpoint_interval_s: float = 60.0

    extra: dict = field(default_factory=dict)

    @classmethod
    def from_env(cls, **overrides) -> "Settings":
        load_dotenv()
        env = os.environ
        kwargs = dict(
            host=env.get("HOST", cls.host),
            port=int(env.get("PORT", cls.port)),
            db_uri=env.get("DATABASE_CONNECTION", cls.db_uri),
            vector_uri=env.get("VECTOR_CONNECTION", cls.vector_uri),
            openai_api_key=env.get("OPENAI_API_KEY") or None,
            openai_base_url=env.get("OPENAI_BASE_URL", cls.openai_base_url),
            local_llm_config=env.get("LOCAL_LLM_CONFIG") or None,
            embedding_model=env.get("EMBEDDING_MODEL", cls.embedding_model),
            search_max_batch=int(
                env.get("MEMEX_SEARCH_MAX_BATCH", cls.search_max_batch)
            ),
        )
        kwargs.update(overrides)
        return cls(**kwargs)
