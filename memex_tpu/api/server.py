"""aiohttp API server.

Design notes vs the reference warp server (lib/api/src/lib.rs:79-124):
  - the embedding engine and vector stores are process-resident (runtime.py)
    instead of being spawned/loaded per request
    (collections/handlers.rs:61-70 — the reference's dominant latency);
  - search hydration is one batched SQL query instead of N sequential
    lookups (collections/handlers.rs:87-102);
  - blocking work (device encode, LLM HTTP) runs on a thread pool so the event
    loop stays responsive.

Route and JSON parity is 1:1 (see api/__init__.py and api/schema.py).
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
from aiohttp import web

from ..db import models, queue
from ..log import get_logger
from ..metrics import METRICS
from ..runtime import Runtime, get_runtime
from . import schema

logger = get_logger(__name__)

GIT_HASH = os.environ.get("MEMEX_GIT_HASH", "dev")
LIMIT_1_MB = 1000 * 1024          # reference endpoints/mod.rs:13-14
LIMIT_10_MB = 10 * LIMIT_1_MB
LIMIT_UPLOAD = 50_000_000          # reference fetch/filters.rs:21


def _error(code: int, message: str) -> web.Response:
    return web.json_response(schema.api_error(code, message), status=code)


@web.middleware
async def error_middleware(request: web.Request, handler):
    METRICS.inc(f"http.{request.method}")
    try:
        with METRICS.timer(f"route{request.path.split('/api')[-1].split('?')[0] or '/'}"):
            return await handler(request)
    except web.HTTPException as exc:
        if exc.status >= 400:
            return _error(exc.status, exc.reason or "error")
        raise
    except json.JSONDecodeError:
        return _error(400, "invalid JSON body")
    except Exception as exc:  # unhandled -> 500, like handle_rejection
        logger.exception("unhandled error on %s", request.path)
        return _error(500, str(exc))


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        resp = await handler(request)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, DELETE, OPTIONS"
    return resp


async def _read_json(request: web.Request, limit: int) -> dict:
    body = await request.read()
    if len(body) > limit:
        raise web.HTTPRequestEntityTooLarge(max_size=limit, actual_size=len(body))
    if not body:
        return {}
    return json.loads(body)


def create_app(runtime: Runtime | None = None) -> web.Application:
    rt = runtime or get_runtime()
    app = web.Application(
        middlewares=[cors_middleware, error_middleware],
        client_max_size=LIMIT_UPLOAD,
    )

    # -- health (lib/api/src/lib.rs:71-77) ------------------------------------
    async def health(request: web.Request) -> web.Response:
        return web.json_response({"version": GIT_HASH})

    # -- collections -----------------------------------------------------------
    async def add_document(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        collection = request.match_info["collection"]
        body = await _read_json(request, LIMIT_10_MB)
        content = body.get("content")
        if not isinstance(content, str) or not content:
            return _error(400, "'content' (string) is required")
        task = queue.enqueue(rt.db, collection, content, queue.TaskType.Ingest)
        return web.json_response(schema.api_response(t0, schema.task_result(task)))

    async def delete_collection(request: web.Request) -> web.Response:
        collection = request.match_info["collection"]

        def work():
            # rt.store() can run a minutes-long first-touch recovery —
            # blocking work stays off the event loop.
            store = rt.store(collection)
            store.delete_all()
            models.delete_collection_embeddings(rt.db, collection)
            rt.drop_store(collection)

        await asyncio.get_running_loop().run_in_executor(None, work)
        return web.Response(status=200)

    async def search_docs(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        collection = request.match_info["collection"]
        # The reference expects a GET body (filters.rs:25-33); accept query
        # params as well for curl-friendliness.
        body = await _read_json(request, LIMIT_1_MB)
        query = body.get("query") or request.query.get("query")
        raw_limit = body.get("limit")
        if raw_limit is None:
            raw_limit = request.query.get("limit", schema.DEFAULT_SEARCH_LIMIT)
        try:
            limit = int(raw_limit)
        except (TypeError, ValueError):
            return _error(400, "'limit' must be an integer")
        if not 1 <= limit <= schema.MAX_SEARCH_LIMIT:
            return _error(400, f"'limit' must be in 1..{schema.MAX_SEARCH_LIMIT}")
        if not query:
            return _error(400, "'query' is required")

        def work():
            # rt.store() first (possible first-touch recovery — minutes of
            # blocking work that must stay off the event loop), then the
            # microbatched search (one encoder call + one fused scan per
            # collection, serve/batcher.py) and the SQL hydration.
            rt.store(collection)
            found = rt.search_batcher.search(collection, query, limit)
            # Batched hydration (vs reference's N+1 loop, handlers.rs:87-102).
            return found, models.get_embeddings_by_uuids(
                rt.db, [h.id for h in found])

        hits, rows = await asyncio.get_running_loop().run_in_executor(None, work)
        results = []
        for h in hits:
            row = rows.get(h.id)
            if row is None:
                continue
            results.append(
                schema.document_segment(h.id, row.document_id, row.segment, row.content, h.score)
            )
        return web.json_response(schema.api_response(t0, {"results": results}))

    # -- tasks (tasks/handlers.rs:8-28) ----------------------------------------
    async def check_task(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        try:
            task_id = int(request.match_info["task_id"])
        except ValueError:
            return _error(400, "task id must be an integer")
        task = queue.get_task(rt.db, task_id)
        if task is None:
            return _error(404, "NOT_FOUND")
        return web.json_response(schema.api_response(t0, schema.task_result(task)))

    # -- actions (actions/handlers.rs) ------------------------------------------
    async def action_ask(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        body = await _read_json(request, LIMIT_10_MB)
        text, user_query = body.get("text"), body.get("query")
        if not text or not user_query:
            return _error(400, "'text' and 'query' are required")
        json_schema = body.get("jsonSchema")
        if json_schema is not None:
            import jsonschema as _js

            try:
                _js.validators.validator_for(json_schema).check_schema(json_schema)
            except Exception as exc:
                return _error(400, f"invalid jsonSchema: {exc}")

        def work():
            from ..llm import prompter

            llm = rt.llm
            content, model = llm.truncate_text(text)
            if json_schema is not None:
                prompt = prompter.json_schema_extraction(content, user_query, json_schema)
            else:
                prompt = prompter.quick_question(
                    f"{user_query}\n\nContent:\n{content}" if content else user_query
                )
            return llm.chat_completion(model, prompt)

        response = await asyncio.get_running_loop().run_in_executor(None, work)
        try:
            val = json.loads(response)
        except json.JSONDecodeError as exc:
            return _error(400, f"LLM response was not valid JSON: {exc}")
        return web.json_response(schema.api_response(t0, {"jsonResponse": val}))

    async def action_summarize(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        body = await _read_json(request, LIMIT_10_MB)
        text = body.get("text")
        if not text:
            return _error(400, "'text' is required")
        # Enqueued under the "tasks" collection (actions/handlers.rs:57).
        task = queue.enqueue(rt.db, "tasks", text, queue.TaskType.Summarize)
        return web.json_response(schema.api_response(t0, schema.task_result(task)))

    # -- fetch (fetch/handlers.rs) ------------------------------------------------
    # SSRF guard (the reference fetches any URL unchecked,
    # fetch/handlers.rs:21-41; this service also exposes network-writable
    # vector routes on the same port, so it must not double as an open
    # proxy): scheme allowlist, no loopback/link-local/private targets
    # unless MEMEX_FETCH_ALLOW_PRIVATE=1, redirects re-checked per hop,
    # response size cap.
    FETCH_MAX_BYTES = 8 * 1024 * 1024
    FETCH_MAX_REDIRECTS = 5

    from .fetch_guard import guarded_fetch

    async def fetch_url(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        url = request.query.get("url")
        if not url:
            return _error(400, "'url' query parameter is required")

        def work():
            return guarded_fetch(url, max_bytes=FETCH_MAX_BYTES,
                                 max_redirects=FETCH_MAX_REDIRECTS)

        try:
            content = await asyncio.get_running_loop().run_in_executor(None, work)
        except Exception as exc:
            return _error(400, f"fetch failed: {exc}")
        return web.json_response(schema.api_response(t0, {"content": content}))

    def _pdf_to_text(pdftotext: str, data: bytes) -> str:
        """Blocking pdftotext conversion — runs on the executor, never the
        event loop (a 120s subprocess would freeze every request)."""
        with tempfile.TemporaryDirectory(
                dir=rt.settings.upload_dir
                if os.path.isdir(rt.settings.upload_dir) else None) as td:
            pdf_path = os.path.join(td, "in.pdf")
            txt_path = os.path.join(td, "out.txt")
            with open(pdf_path, "wb") as fh:
                fh.write(data)
            proc = subprocess.run(
                [pdftotext, pdf_path, txt_path], capture_output=True, timeout=120
            )
            if proc.returncode != 0:
                raise ValueError(
                    f"pdftotext failed: {proc.stderr.decode()[:200]}")
            with open(txt_path, "r", encoding="utf-8", errors="replace") as fh:
                return fh.read()

    async def fetch_parse(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        reader = await request.multipart()
        parsed: list[str] = []
        pdftotext = shutil.which("pdftotext")
        loop = asyncio.get_running_loop()
        async for field in reader:
            data = await field.read(decode=False)
            name = field.filename or field.name or "upload"
            if name.lower().endswith(".pdf") or (field.headers.get("Content-Type") == "application/pdf"):
                if not pdftotext:
                    return _error(400, "pdftotext not available on this host")
                try:
                    parsed.append(await loop.run_in_executor(
                        None, _pdf_to_text, pdftotext, data))
                except ValueError as exc:
                    return _error(400, str(exc))
            else:
                parsed.append(data.decode("utf-8", errors="replace"))
        return web.json_response(schema.api_response(t0, {"parsed": parsed}))

    # -- raw vector ops (network delegation surface: lets another memex_tpu
    #    use this service as its vector backend, the role OpenSearch plays
    #    for the reference — storage/opensearch.rs:137-223) -------------------
    async def vectors_add(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        collection = request.match_info["collection"]
        body = await _read_json(request, LIMIT_UPLOAD)
        items = body.get("items")
        if not isinstance(items, list) or not items:
            return _error(400, "'items' (non-empty list) is required")

        def work():
            from ..store.base import VectorData

            store = rt.store(collection)
            store.add_vectors([
                VectorData(
                    id=i["id"], document_id=i.get("documentId", ""),
                    text=i.get("text", ""),
                    vector=np.asarray(i["vector"], np.float32),
                    segment_id=int(i.get("segmentId", 0)),
                )
                for i in items
            ])
            return store.count

        count = await asyncio.get_running_loop().run_in_executor(None, work)
        return web.json_response(schema.api_response(t0, {"count": count}))

    async def vectors_search(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        collection = request.match_info["collection"]
        body = await _read_json(request, LIMIT_10_MB)
        vectors = body.get("vectors")
        limit = int(body.get("limit", schema.DEFAULT_SEARCH_LIMIT))
        if not isinstance(vectors, list) or not vectors:
            return _error(400, "'vectors' (non-empty list of float lists) is required")
        if not 1 <= limit <= schema.MAX_SEARCH_LIMIT:
            return _error(400, f"'limit' must be in 1..{schema.MAX_SEARCH_LIMIT}")

        def work():
            store = rt.store(collection)
            return store.search_batch(np.asarray(vectors, np.float32), limit)

        batches = await asyncio.get_running_loop().run_in_executor(None, work)
        return web.json_response(schema.api_response(t0, {
            "results": [
                [{"id": h.id, "score": h.score, "documentId": h.document_id}
                 for h in hits]
                for hits in batches
            ]
        }))

    async def vectors_delete(request: web.Request) -> web.Response:
        t0 = time.perf_counter()
        collection = request.match_info["collection"]
        body = await _read_json(request, LIMIT_10_MB)
        ids = body.get("ids")
        if ids is None:  # no ids -> drop the whole collection index
            def work_all():
                rt.store(collection).delete_all()
                rt.drop_store(collection)
                return 0

            n = await asyncio.get_running_loop().run_in_executor(None, work_all)
        else:
            if not isinstance(ids, list) or not all(
                    isinstance(i, str) for i in ids):
                # A bare string would be exploded per character by list();
                # sibling handlers validate their payload shapes too.
                return _error(400, "'ids' must be a list of strings")

            def work():
                return rt.store(collection).delete(ids)

            n = await asyncio.get_running_loop().run_in_executor(None, work)
        return web.json_response(schema.api_response(t0, {"removed": n}))

    # -- stats (new vs reference: metrics export, SURVEY.md §5) ---------------
    async def stats(request: web.Request) -> web.Response:
        snap = METRICS.snapshot()
        collections = {}
        for row in rt.db.query(
            "SELECT collection, COUNT(*) AS n FROM embeddings GROUP BY collection"
        ):
            collections[row["collection"]] = row["n"]
        q = {
            r["status"]: r["n"]
            for r in rt.db.query("SELECT status, COUNT(*) AS n FROM queue GROUP BY status")
        }
        snap["collections"] = collections
        snap["queue"] = q
        return web.json_response(snap)

    app.router.add_get("/api/health", health)
    app.router.add_get("/api/stats", stats)
    app.router.add_post("/api/collections/{collection}", add_document)
    app.router.add_delete("/api/collections/{collection}", delete_collection)
    app.router.add_route("GET", "/api/collections/{collection}/search", search_docs)
    app.router.add_post("/api/collections/{collection}/search", search_docs)
    app.router.add_post("/api/vectors/{collection}", vectors_add)
    app.router.add_post("/api/vectors/{collection}/search", vectors_search)
    app.router.add_post("/api/vectors/{collection}/delete", vectors_delete)
    app.router.add_get("/api/tasks/{task_id}", check_task)
    app.router.add_post("/api/action/ask", action_ask)
    app.router.add_post("/api/action/summarize/task", action_summarize)
    app.router.add_get("/api/fetch", fetch_url)
    app.router.add_post("/api/fetch/parse", fetch_parse)
    return app


async def start_async(runtime: Runtime | None = None, shutdown_event: asyncio.Event | None = None):
    rt = runtime or get_runtime()
    os.makedirs(rt.settings.upload_dir, exist_ok=True)
    # Blocking handler work (store access, batcher waits, SQL hydration)
    # runs in the loop's default executor; the stdlib default of
    # cpu_count+4 threads (5 on a 1-core host) would cap the
    # number of in-flight requests — and therefore the microbatcher's
    # batch fill — at 5. Size it to the search batch so concurrency is
    # bounded by the batcher, not the thread pool.
    from concurrent.futures import ThreadPoolExecutor

    asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(
        max_workers=rt.settings.search_max_batch + 8,
        thread_name_prefix="memex-api"))
    app = create_app(rt)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, rt.settings.host, rt.settings.port)
    await site.start()
    logger.info("api server listening on %s:%d", rt.settings.host, rt.settings.port)
    try:
        if shutdown_event is not None:
            await shutdown_event.wait()
        else:
            while True:
                await asyncio.sleep(3600)
    finally:
        await runner.cleanup()


def start(runtime: Runtime | None = None) -> None:
    asyncio.run(start_async(runtime))
