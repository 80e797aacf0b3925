"""CLI entry point / process supervisor.

Reference: bin/memex/src/main.rs — `memex serve --roles Api,Worker` with
env fallbacks (Args :20-33, role spawn :113-130). Both roles run in one
process by default (threads), or split across processes sharing the SQL
queue, exactly like the reference's role model.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from .config import Settings, load_dotenv
from .log import get_logger, init_logging

logger = get_logger("memex_tpu.main")


def cmd_serve(args: argparse.Namespace) -> int:
    from .runtime import get_runtime

    settings = Settings.from_env(
        **{k: v for k, v in {
            "host": args.host,
            "port": args.port,
            "db_uri": args.database_connection,
            "vector_uri": args.vector_connection,
        }.items() if v is not None}
    )
    # Multi-host bring-up FIRST: jax.distributed.initialize must run
    # before anything initializes XLA backends (jax.default_backend() below
    # does), or serve crashes/silently runs single-host under
    # MEMEX_COORDINATOR. No-op unless MEMEX_COORDINATOR is set.
    from .parallel.distributed import init_multihost

    init_multihost()

    # Persistent XLA compile cache (compile_cache.py): first-touch
    # compiles (encoder buckets, index write blocks, fused scans) otherwise
    # land in early request latency on every cold start.
    import jax

    from .compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    logger.info("jax devices: %s (backend %s, compile cache %s)",
                jax.devices(), jax.default_backend(), cache_dir)

    rt = get_runtime(settings)
    roles = {r.strip().lower() for r in args.roles.split(",") if r.strip()}
    if not roles or not roles <= {"api", "worker"}:
        # An empty set would pass a bare subset check and park the process
        # doing nothing (no listener, no worker, no explanation).
        logger.error("invalid roles %r (expected Api,Worker)", args.roles)
        return 2

    worker = None
    if "worker" in roles:
        from .worker import Worker

        worker = Worker(rt)
        worker.start_background()

    stop = threading.Event()

    def handle_sig(signum, frame):
        logger.info("shutdown signal received")
        stop.set()

    signal.signal(signal.SIGINT, handle_sig)
    signal.signal(signal.SIGTERM, handle_sig)

    if "api" in roles:
        import asyncio

        from .api.server import start_async

        # Warm every fused-query-path executable for existing collections
        # BEFORE accepting traffic: an unwarmed microbatch bucket compiles
        # inside a request. MEMEX_WARM_SERVE=0 opts out; CPU backends skip
        # (compiles there are milliseconds). A warmup failure on a device
        # backend is an error, not a slower start.
        if (os.environ.get("MEMEX_WARM_SERVE", "1") != "0"
                and jax.default_backend() != "cpu"):
            cols = rt.db.query("SELECT DISTINCT collection FROM embeddings")
            for row in cols:
                n = rt.search_batcher.warmup(row["collection"])
                logger.info("serve warmup: %s -> %d executables",
                            row["collection"], n)

        async def main():
            shutdown_event = asyncio.Event()

            def poll_stop():
                if stop.is_set():
                    shutdown_event.set()
                else:
                    asyncio.get_event_loop().call_later(0.2, poll_stop)

            asyncio.get_event_loop().call_later(0.2, poll_stop)
            await start_async(rt, shutdown_event)

        asyncio.run(main())
    else:
        stop.wait()

    if worker is not None:
        worker.shutdown()  # flushes checkpoints via rt.checkpoint_all()
    else:
        # Api-only role: no worker shutdown ran, flush stores here. One
        # O(count) save per store is enough — worker.shutdown() already
        # checkpoints, so no second pass when a worker exists.
        try:
            rt.checkpoint_all()
        except Exception:
            logger.exception("checkpoint on shutdown failed")
    return 0


def cmd_load(args: argparse.Namespace) -> int:
    """Bulk-enqueue documents from files/dirs (data-loader role; the
    reference's closest analogue is clippy load-file, one doc at a time)."""
    import glob
    import os

    from .db import queue
    from .runtime import get_runtime

    rt = get_runtime()
    paths: list[str] = []
    for p in args.paths:
        if os.path.isdir(p):
            paths.extend(sorted(glob.glob(os.path.join(p, "**", "*"), recursive=True)))
        else:
            paths.append(p)
    items = []
    for p in paths:
        if not os.path.isfile(p):
            continue
        try:
            with open(p, "r", encoding="utf-8", errors="replace") as fh:
                content = fh.read()
        except OSError as exc:
            logger.warning("skipping %s: %s", p, exc)
            continue
        if content.strip():
            items.append((args.collection, content, queue.TaskType.Ingest))
    queue.enqueue_many(rt.db, items)
    logger.info("enqueued %d documents into %r", len(items), args.collection)
    if args.wait:
        from .worker import Worker

        Worker(rt).drain(timeout=args.timeout)
    return 0


def cmd_download_model(args: argparse.Namespace) -> int:
    """Fetch model weights into a local dir (parity with the reference's
    `make setup-examples` download target, Makefile:22-28). Needs network;
    in air-gapped environments place an HF-format checkpoint
    (model.safetensors + config.json + vocab.txt) at the target dir by any
    other means — the loader (models/minilm.py) only reads local files."""
    import os

    target = args.target or os.path.join("models", args.model.split("/")[-1])
    needed = ["model.safetensors", "config.json", "vocab.txt"]
    if all(os.path.exists(os.path.join(target, f)) for f in needed):
        logger.info("model already present at %s", target)
        return 0
    try:
        from huggingface_hub import snapshot_download

        snapshot_download(
            repo_id=args.model,
            local_dir=target,
            allow_patterns=["*.safetensors", "config.json", "vocab.txt",
                            "tokenizer_config.json", "special_tokens_map.json"],
        )
    except Exception as exc:
        logger.error(
            "download failed (%s). If this host has no egress, copy an "
            "HF-format checkpoint (%s) into %s manually and set "
            "EMBEDDING_MODEL=%s.", exc, ", ".join(needed), target, target,
        )
        return 1
    missing = [f for f in needed if not os.path.exists(os.path.join(target, f))]
    if missing:
        logger.error("snapshot incomplete, missing: %s", missing)
        return 1
    logger.info("model ready at %s (set EMBEDDING_MODEL=%s)", target, target)
    return 0


def cmd_train(args: argparse.Namespace) -> int:
    """Fine-tune the encoder on an ingested collection and export the
    result in HF format (loadable via EMBEDDING_MODEL=<out>)."""
    import json

    from .runtime import get_runtime
    from .train import TrainConfig, train_encoder

    rt = get_runtime()
    metrics = train_encoder(
        rt,
        args.collection,
        epochs=args.epochs,
        batch_size=args.batch_size,
        tc=TrainConfig(learning_rate=args.learning_rate),
        out_dir=args.out,
        resume=args.resume,
        checkpoint_path=args.checkpoint,
    )
    print(json.dumps(metrics))
    return 0


def cmd_migrate(args: argparse.Namespace) -> int:
    """Standalone migration runner (reference migration/src/main.rs)."""
    from .db.connection import create_connection_by_uri

    settings = Settings.from_env()
    uri = args.database_connection or settings.db_uri
    create_connection_by_uri(uri, run_migrations=True)
    logger.info("migrations applied to %s", uri)
    return 0


def main(argv: list[str] | None = None) -> int:
    load_dotenv()
    init_logging()
    # Honor JAX_PLATFORMS even when a site plugin force-registers a backend
    # and rewrites jax_platforms at import (the env var alone loses then).
    import os

    if os.environ.get("JAX_PLATFORMS"):
        import jax

        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    parser = argparse.ArgumentParser(prog="memex_tpu", description="accelerator-resident memex service")
    sub = parser.add_subparsers(dest="command", required=True)

    serve = sub.add_parser("serve", help="run the api/worker service")
    serve.add_argument("--host", default=None)
    serve.add_argument("--port", type=int, default=None)
    serve.add_argument("--roles", default="Api,Worker")
    serve.add_argument("--database-connection", default=None)
    serve.add_argument("--vector-connection", default=None)
    serve.set_defaults(func=cmd_serve)

    migrate = sub.add_parser("migrate", help="apply schema migrations and exit")
    migrate.add_argument("--database-connection", default=None)
    migrate.set_defaults(func=cmd_migrate)

    tr = sub.add_parser("train", help="fine-tune the encoder on a collection")
    tr.add_argument("collection")
    tr.add_argument("--epochs", type=int, default=1)
    tr.add_argument("--batch-size", type=int, default=32)
    tr.add_argument("--learning-rate", type=float, default=2e-5)
    tr.add_argument("--out", default=None, help="export dir (HF format)")
    tr.add_argument("--resume", default=None, help="train-state .npz to resume")
    tr.add_argument("--checkpoint", default=None, help="train-state .npz to write")
    tr.set_defaults(func=cmd_train)

    dl = sub.add_parser("download-model", help="fetch embedding-model weights")
    dl.add_argument("--model", default="sentence-transformers/all-MiniLM-L12-v2")
    dl.add_argument("--target", default=None, help="output dir (default models/<name>)")
    dl.set_defaults(func=cmd_download_model)

    load = sub.add_parser("load", help="bulk-enqueue documents from files/dirs")
    load.add_argument("collection")
    load.add_argument("paths", nargs="+")
    load.add_argument("--wait", action="store_true", help="run a worker until drained")
    load.add_argument("--timeout", type=float, default=3600.0)
    load.set_defaults(func=cmd_load)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
