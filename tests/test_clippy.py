"""clippy example CLI end-to-end against a live in-process server."""

import asyncio
import os
import socket
import sys
import threading
import time

import pytest

os.environ["MEMEX_FAKE_LLM"] = "1"

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))

import clippy  # noqa: E402

from memex_tpu.api.server import start_async  # noqa: E402
from memex_tpu.config import Settings  # noqa: E402
from memex_tpu.runtime import Runtime  # noqa: E402
from memex_tpu.worker import Worker  # noqa: E402

from test_encoder import tiny_engine  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def live_server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clippy")
    port = free_port()
    settings = Settings.from_env(
        host="127.0.0.1",
        port=port,
        db_uri=f"sqlite://{tmp}/c.db",
        vector_uri="memory://",
        embedding_model="random",
    )
    settings.embedding_dim = 64
    rt = Runtime(settings)
    rt._engine = tiny_engine()
    worker = Worker(rt, poll_interval=0.01)
    worker.start_background()

    loop = asyncio.new_event_loop()
    stop = asyncio.Event()

    def run_server():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(start_async(rt, stop))

    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    host = f"http://127.0.0.1:{port}"
    for _ in range(100):
        try:
            import requests

            if requests.get(f"{host}/api/health", timeout=1).ok:
                break
        except Exception:
            time.sleep(0.1)
    else:
        pytest.fail("server did not start")
    yield host
    loop.call_soon_threadsafe(stop.set)
    worker.shutdown(wait=False)
    thread.join(timeout=5)


def test_load_ask_qq_forget(live_server, tmp_path, capsys):
    doc = tmp_path / "doc.txt"
    doc.write_text(
        "The memex_tpu project stores vectors on the GPU. "
        "Retrieval runs a fused Pallas kernel. " * 3
    )
    assert clippy.main(["--host", live_server, "load-file", str(doc)]) == 0
    out = capsys.readouterr().out
    assert "ingest completed" in out

    assert clippy.main(["--host", live_server, "ask", "where are vectors stored?"]) == 0
    out = capsys.readouterr().out
    assert "context segments" in out

    assert clippy.main(["--host", live_server, "qq", "quick question"]) == 0

    assert clippy.main(["--host", live_server, "forget"]) == 0
    out = capsys.readouterr().out
    assert "deleted" in out
