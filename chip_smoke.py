#!/usr/bin/env python3
"""On-card smoke test: drives memex_tpu's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # one card: serve, scale, LLM, kernels
    python3 chip_smoke.py --cards 4    # four cards: the sharded stores only

Phases (one card):
  1. serve   `python -m memex_tpu serve --roles Api,Worker` as a child
             process on the card: ingest documents over HTTP, answer text
             and vector searches. The parent stays off the card meanwhile
             and checks answers against numpy.
  2. scale   1,048,576 x 384 clustered unit vectors through the registry
             store and FlatIndex.add, for float32, float32 with an exact
             scan, and int8 + refine; recall@10 against a numpy float32
             oracle for vector queries and for text queries through the
             serve path's SearchBatcher; kernel-vs-XLA search QPS.
  3. llm     LocalLLM at the TinyLlama-1.1B geometry with random bf16
             weights: 32 tokens through the chat path, prefill logits
             against a float32 reference at HIGHEST precision.
  4. kernels the fused flat scan kernel (ops/scan_topk.py) compiled at
             1M x 384 for each mode, compared with its plain reference
             and timed against XLA's plain scan, in turns.
With --cards 4: `tpu+mesh://` and `tpu+ivf+mesh://` at 1M int8 rows per
card over a 1-D mesh of the four cards, against the same exact float32
oracle (benchmarks/datasets.oracle_topk: numpy up to 2M rows, 1M-row
device blocks at HIGHEST precision beyond).

The last line of stdout is one JSON object; every failure exits non-zero
before it. Inputs are made from --seed; weights are random.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_SCALE = 1 << 20
DIM = 384
K = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def recall_at_k(got: list[list[str]], want: np.ndarray) -> float:
    return float(np.mean([len(set(g[:K]) & {str(int(j)) for j in w[:K]}) / K
                          for g, w in zip(got, want)]))


def oracle(corpus: np.ndarray, queries: np.ndarray) -> np.ndarray:
    from memex_tpu.benchmarks.datasets import oracle_topk

    return oracle_topk(corpus, queries, K)


# -- phase 1: the HTTP server as a child process --------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method: str, url: str, body: dict | None = None, timeout=300.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"null")


def phase_serve(seed: int, tmp: str) -> None:
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, JAX_PLATFORMS="cuda", HOST="127.0.0.1",
               PORT=str(port), DATABASE_CONNECTION=f"sqlite://{tmp}/memex.db",
               MEMEX_FAKE_LLM="1", PYTHONPATH=HERE)
    env.pop("VECTOR_CONNECTION", None)  # the default tpu:// float32 store
    log_path = os.path.join(tmp, "server.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "memex_tpu", "serve", "--roles", "Api,Worker"],
            cwd=tmp, env=env, stdout=logf, stderr=subprocess.STDOUT)
    try:
        _drive_server(base, proc, seed)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        with open(log_path) as fh:
            server_log = fh.read()
        dev = [ln for ln in server_log.splitlines() if "jax devices:" in ln]
        log("serve: server log:", dev[0].split("jax devices:")[-1].strip()
            if dev else "(no device line)")
        if not dev:
            log(server_log[-4000:])
    check(bool(dev) and "Cuda" in dev[0], "server did not log a CUDA device")
    check(proc.returncode == 0, f"server exited with {proc.returncode}")


def _drive_server(base: str, proc, seed: int) -> None:
    t0 = time.time()
    while True:
        check(proc.poll() is None, "server exited during start-up")
        try:
            _http("GET", base + "/api/health", timeout=5)
            break
        except OSError:
            check(time.time() - t0 < 300, "server did not answer in 300 s")
            time.sleep(1)
    log(f"serve: healthy after {time.time() - t0:.1f} s")

    # Ingest: one short sentence per document, so each is one window.
    topics = ["tides", "volcanoes", "sourdough", "comets", "glaciers",
              "violins", "beekeeping", "chess", "lichens", "monsoons",
              "origami", "falconry", "typesetting", "coral", "kites",
              "saffron", "lighthouses", "bonsai", "telescopes", "mosaics"]
    docs = {t: f"A field note about {t} and the people who study {t}."
            for t in topics}
    tasks = {}
    for t, text in docs.items():
        r = _http("POST", base + "/api/collections/smoke", {"content": text})
        tasks[t] = r["result"]["taskId"]
    done = {}
    t0 = time.time()
    while len(done) < len(tasks):
        for t, tid in tasks.items():
            if t in done:
                continue
            st = _http("GET", f"{base}/api/tasks/{tid}")["result"]["status"]
            check(st != "Failed", f"ingest task {tid} failed")
            if st == "Completed":
                done[t] = tid
        check(time.time() - t0 < 600, "ingest tasks not Completed in 600 s")
        time.sleep(0.5)
    log(f"serve: {len(done)} ingest tasks Completed in {time.time() - t0:.1f} s")

    # Text search through the SearchBatcher (encode + scan): each document's
    # own text must find that document first.
    hits_ok = 0
    for t, text in docs.items():
        res = _http("POST", base + "/api/collections/smoke/search",
                    {"query": text, "limit": 3})["result"]["results"]
        check(len(res) > 0, f"no search results for {t!r}")
        hits_ok += t in res[0]["content"]
    log(f"serve: text search top-1 is the queried document for "
        f"{hits_ok}/{len(docs)} queries")
    check(hits_ok == len(docs), "text search missed a queried document")

    # Vector routes at 16k rows, checked against numpy.
    from memex_tpu.benchmarks.datasets import make_corpus, make_queries

    n = 16384
    corpus = make_corpus(n, DIM, seed=seed)
    queries = make_queries(corpus, 32, seed=seed + 1)
    for s in range(0, n, 2048):
        items = [{"id": str(i), "vector": corpus[i].tolist()}
                 for i in range(s, min(n, s + 2048))]
        _http("POST", base + "/api/vectors/vec", {"items": items})
    res = _http("POST", base + "/api/vectors/vec/search",
                {"vectors": queries.tolist(), "limit": K})["result"]["results"]
    rec = recall_at_k([[h["id"] for h in r] for r in res], oracle(corpus, queries))
    log(f"serve: /api/vectors at {n} rows: recall@10 {rec:.4f} (bar 0.95)")
    check(rec >= 0.95, "vector search recall below 0.95")


# -- phase 2: 1M rows in one process -------------------------------------------


SCALE_STORES = [
    # (name, uri query, recall bar against the float32 oracle)
    ("float32", "", 0.95),
    ("float32 scan_precision=highest", "?scan_precision=highest", 0.999),
    ("int8 refine=1", "?dtype=int8&refine=1", 0.99),
]


def _device_mb() -> float:
    import jax

    return jax.devices()[0].memory_stats()["bytes_in_use"] / 2**20


def _text_queries(n: int) -> list[str]:
    words = ["river", "archive", "signal", "harvest", "lantern", "quartz",
             "meadow", "engine", "harbor", "ledger", "canyon", "orchid"]
    return [f"notes on {words[i % 12]} {words[(i // 12) % 12]} number {i}"
            for i in range(n)]


def phase_scale(seed: int, tmp: str, timings: dict) -> None:
    from memex_tpu.benchmarks.datasets import make_corpus, make_queries, unit_rows
    from memex_tpu.config import Settings
    from memex_tpu.runtime import Runtime

    rng = np.random.default_rng(seed)
    texts = _text_queries(256)
    rt0 = Runtime(Settings(db_uri=f"sqlite://{tmp}/scale.db",
                           vector_uri=f"tpu://{tmp}/unused"))
    text_vecs = np.asarray(rt0.engine.encode_batch(texts), np.float32)
    # Ten planted neighbours per text query, so that its top-10 stands
    # clear of the clustered background and of the other queries' plants.
    # A random encoder maps all texts close together (pairwise cos ~0.99),
    # so each plant leans along its query's own offset from the batch mean.
    off = text_vecs - text_vecs.mean(axis=0)
    lean = text_vecs + off / np.linalg.norm(off, axis=1, keepdims=True)
    planted = unit_rows(np.repeat(lean, K, axis=0) + (0.05 / np.sqrt(DIM))
                        * rng.standard_normal((len(texts) * K, DIM)).astype(np.float32))
    corpus = np.concatenate([make_corpus(N_SCALE - len(planted), DIM, seed=seed),
                             planted])
    ids = [str(i) for i in range(N_SCALE)]
    vq = make_queries(corpus, 256, seed=seed + 1)
    t0 = time.time()
    want_v, want_t = oracle(corpus, vq), oracle(corpus, text_vecs)
    log(f"scale: corpus {corpus.shape}, numpy oracles in {time.time() - t0:.1f} s")
    bench_q = make_queries(corpus, 512, seed=seed + 2)

    for name, query, bar in SCALE_STORES:
        uri = f"tpu://{tmp}/{name.split()[0]}{query}"
        rt = Runtime(Settings(db_uri=f"sqlite://{tmp}/scale.db", vector_uri=uri))
        rt._engine = rt0.engine  # one encoder for every store
        store = rt.store("scale")
        t0 = time.time()
        with store._lock:
            store.index.add(corpus, ids)
        add_s = time.time() - t0
        got = store.search_batch(vq, K)
        rec_v = recall_at_k([[h.id for h in r] for r in got], want_v)
        with ThreadPoolExecutor(64) as pool:
            got_t = list(pool.map(
                lambda t: rt.search_batcher.search("scale", t, K), texts))
        rec_t = recall_at_k([[h.id for h in r] for r in got_t], want_t)
        log(f"scale: {name}: add {N_SCALE} rows {add_s:.1f} s; recall@10 "
            f"store.search_batch {rec_v:.4f}, search_batcher {rec_t:.4f} "
            f"(bar {bar}); device memory in use {_device_mb():.0f} MiB")
        check(rec_v >= bar and rec_t >= bar, f"{name}: recall below {bar}")
        if store.index.mode != "exact":
            timings[name] = _time_flat_search(store.index, bench_q)
        rt.search_batcher.close()
        rt.drop_store("scale")
        del store, rt
        gc.collect()


def _time_flat_search(index, queries: np.ndarray) -> dict:
    """FlatIndex.search end to end (device search, fetch, id hydration)
    with the fused kernel and with the XLA scan, in turns (A B B A)."""
    from memex_tpu.ops.host import fetch

    def run(q, kernel):
        k_ret = max(K, index.rerank or 0)
        vals, idx = fetch(*index._device_search(q, K, k_ret, kernel))
        return index._hits_from(vals, idx, q.shape[0])

    out = {}
    for qn in (32, 128, 512):
        q = queries[:qn]
        res = {True: [], False: []}
        for kernel in (True, False):
            run(q, kernel)  # compile + warm
        for kernel in (True, False, False, True):
            t0 = time.perf_counter()
            for _ in range(5):
                run(q, kernel)
            res[kernel].append((time.perf_counter() - t0) / 5)
        kq = qn / np.mean(res[True])
        xq = qn / np.mean(res[False])
        out[qn] = (kq, xq)
        log(f"scale:   FlatIndex.search Q={qn}: kernel {kq:.0f} QPS, "
            f"XLA {xq:.0f} QPS ({kq / xq:.2f}x)")
    return out


# -- phase 3: local LLM decode ---------------------------------------------------


class _CountingTokenizer:
    """ByteTokenizer that remembers the ids of the last decode."""

    def __init__(self):
        from memex_tpu.llm.local.runtime import ByteTokenizer

        self._tok = ByteTokenizer()
        self.bos_id, self.eos_id = self._tok.bos_id, self._tok.eos_id
        self.vocab_size = self._tok.vocab_size
        self.last: list[int] = []

    def encode(self, text):
        return self._tok.encode(text)

    def decode(self, ids):
        self.last = list(ids)
        return self._tok.decode(ids)


def phase_llm(seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from memex_tpu.benchmarks.llm_bench import GEOMETRIES
    from memex_tpu.llm.base import ChatMessage, ChatRole
    from memex_tpu.llm.local import LocalLLM
    from memex_tpu.llm.local.model import (LlamaConfig, SamplerConfig,
                                           convert_params, forward,
                                           init_cache, init_params)

    cfg = LlamaConfig(**GEOMETRIES["tinyllama-1.1b"])
    params = convert_params(init_params(cfg, seed=seed), "bfloat16")
    jax.block_until_ready(params)
    tok = _CountingTokenizer()
    llm = LocalLLM(cfg, params, tok, SamplerConfig(), seed=seed)
    t0 = time.time()
    llm.chat_completion(llm.default_model,
                        [ChatMessage(ChatRole.User, "Summarize the tides.")],
                        max_new=32)
    log(f"llm: {len(tok.last)} tokens decoded through LocalLLM.chat_completion "
        f"in {time.time() - t0:.1f} s (compile included)")
    check(len(tok.last) == 32, "chat path did not decode 32 tokens")

    # Prefill logits against float32 weights and activations at HIGHEST.
    rng = np.random.default_rng(seed)
    T = 64
    prompt = jnp.asarray(rng.integers(5, cfg.vocab_size, (1, T)), jnp.int32)
    pos = jnp.arange(T)[None, :]
    got, _ = jax.jit(lambda p, x: forward(cfg, p, x, pos, init_cache(cfg), 0))(
        params, prompt)
    cfg32 = LlamaConfig(**{**GEOMETRIES["tinyllama-1.1b"],
                           "compute_dtype": "float32"})
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    with jax.default_matmul_precision("highest"):
        ref, _ = jax.jit(lambda p, x: forward(cfg32, p, x, pos,
                                              init_cache(cfg32), 0))(params32, prompt)
    got, ref = np.asarray(got[0]), np.asarray(ref[0])
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    agree = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
    # bf16 activations keep 8 significant bits; over 22 layers the logits'
    # max-norm error stays within 5% of the logits' max magnitude.
    log(f"llm: prefill logits vs float32 HIGHEST reference: max |diff| / "
        f"max |ref| = {rel:.4f} (tolerance 0.05), argmax agreement {agree:.3f}")
    check(np.isfinite(got).all() and got.shape == (T, cfg.vocab_size),
          "prefill logits not finite or of the wrong shape")
    check(rel <= 0.05, "prefill logits outside tolerance")
    del params, params32, llm
    gc.collect()


# -- phase 4: the fused kernel at real width ------------------------------------


def phase_kernels(seed: int, timings: dict) -> None:
    import jax
    import jax.numpy as jnp

    from memex_tpu.benchmarks.datasets import make_corpus, make_queries
    from memex_tpu.index.flat import _search_xla
    from memex_tpu.ops.quant import quantize_rows_int8
    from memex_tpu.ops.scan_topk import reference_topk, scan_topk

    corpus = make_corpus(N_SCALE, DIM, seed=seed + 3)
    queries = make_queries(corpus, 512, seed=seed + 4)
    buf32 = jnp.asarray(corpus)
    codes, scales = quantize_rows_int8(buf32)
    for mode, buf, sc in (("bf16", buf32, None), ("int8q", codes, scales)):
        q = jnp.asarray(queries[:256])
        t0 = time.time()
        kv, ki = jax.block_until_ready(
            scan_topk(buf, q, sc, None, N_SCALE, K, mode=mode))
        compile_s = time.time() - t0
        rv, ri = reference_topk(buf, q, sc, None, N_SCALE, 256, mode=mode)
        rv, ri, kv, ki = map(np.asarray, (rv, ri, kv, ki))
        rec = recall_at_k([[str(j) for j in r] for r in ki], ri[:, :K])
        # Reference score of every row the kernel returned (rows outside
        # the reference's top-256 are not compared; they count as misses).
        diffs = []
        for qi in range(ri.shape[0]):
            pos = dict(zip(ri[qi].tolist(), rv[qi].tolist()))
            diffs += [abs(v - pos[j]) / abs(pos[j]) if mode == "int8q"
                      else abs(v - pos[j])
                      for v, j in zip(kv[qi], ki[qi]) if j in pos]
        tol, kind = (1e-5, "relative") if mode == "int8q" else (1e-3, "absolute")
        log(f"kernels: {mode}: compile+first call {compile_s:.1f} s; recall@10 "
            f"vs plain reference {rec:.4f} (bar 0.99); max {kind} score diff "
            f"{max(diffs):.2e} (tolerance {tol:g})")
        check(rec >= 0.99, f"{mode} kernel recall below 0.99")
        check(max(diffs) <= tol, f"{mode} kernel scores outside tolerance")
        alive = jnp.ones((N_SCALE,), jnp.float32)
        for qn in (32, 128, 512):
            qq = jnp.asarray(queries[:qn])
            fns = {
                "kernel": lambda: scan_topk(buf, qq, sc, None, N_SCALE, K,
                                            mode=mode),
                "xla": lambda: _search_xla(buf, sc, alive, N_SCALE, qq, K),
            }
            res = {"kernel": [], "xla": []}
            for name in fns:
                jax.block_until_ready(fns[name]())
            for name in ("kernel", "xla", "xla", "kernel"):
                t0 = time.perf_counter()
                for _ in range(10):
                    r = fns[name]()
                jax.block_until_ready(r)
                res[name].append((time.perf_counter() - t0) / 10 * 1e3)
            km, xm = np.mean(res["kernel"]), np.mean(res["xla"])
            timings[f"{mode} Q={qn}"] = (km, xm)
            log(f"kernels:   {mode} Q={qn}: kernel {km:.3f} ms, XLA {xm:.3f} ms "
                f"({xm / km:.1f}x)")


# -- --cards 4: the sharded stores ----------------------------------------------


def phase_mesh(seed: int, tmp: str) -> None:
    import jax

    from memex_tpu.benchmarks.datasets import make_corpus, make_queries
    from memex_tpu.store import get_vector_storage

    n_dev = len(jax.devices())
    check(n_dev == 4, f"--cards 4 needs 4 devices, JAX sees {n_dev}")
    n = N_SCALE * n_dev
    corpus = make_corpus(n, DIM, seed=seed)
    queries = make_queries(corpus, 256, seed=seed + 1)
    t0 = time.time()
    want = oracle(corpus, queries)
    log(f"mesh: corpus {corpus.shape}, oracle in {time.time() - t0:.1f} s")
    ids = [str(i) for i in range(n)]
    for uri, bar in ((f"tpu+mesh://{tmp}/m?dtype=int8&capacity_per_shard="
                      f"{N_SCALE}", 0.95),
                     (f"tpu+ivf+mesh://{tmp}/mi?n_clusters=1024&nprobe=64"
                      "&refine=1", 0.95)):
        store = get_vector_storage(uri, "mesh", dim=DIM)
        t0 = time.time()
        with store._lock:
            if uri.startswith("tpu+ivf"):
                store.index.build(corpus, ids)  # TpuMeshIVFStore.build's core
                buf = store.index.data
            else:
                store.index.add(corpus, ids)
                buf = store.index.buf
        load_s = time.time() - t0
        shard_devs = {s.device for s in buf.addressable_shards}
        check(len(buf.sharding.device_set) == n_dev and len(shard_devs) == n_dev,
              f"{uri}: shards sit on {len(shard_devs)} distinct devices")
        got = store.search_batch(queries, K)
        rec = recall_at_k([[h.id for h in r] for r in got], want)
        t0 = time.perf_counter()
        for _ in range(5):
            store.search_batch(queries, K)
        qps = 5 * len(queries) / (time.perf_counter() - t0)
        log(f"mesh: {uri.split(':')[0]}: {n} rows on {len(shard_devs)} "
            f"distinct devices {sorted(str(d) for d in shard_devs)}; "
            f"load {load_s:.1f} s; recall@10 {rec:.4f} (bar {bar}); "
            f"{qps:.0f} QPS at Q=256")
        check(rec >= bar, f"{uri}: recall below {bar}")
        del store
        gc.collect()


# -- entry -----------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "memex_tpu")):
        print("chip_smoke.py: the memex_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        log(card_line())
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke.py: no NVIDIA GPU ({exc})", file=sys.stderr)
        return 2

    tmp = tempfile.mkdtemp(prefix="memex_smoke_")
    timings: dict = {}
    t_start = time.time()
    try:
        if args.cards == 1:
            phase_serve(args.seed, tmp)  # the parent has not opened the card
        import jax

        from memex_tpu.compile_cache import enable_compile_cache

        enable_compile_cache()
        dev = jax.devices()[0]
        check(dev.platform == "gpu", f"JAX found no GPU (platform {dev.platform})")
        if args.cards == 4:
            phase_mesh(args.seed, tmp)
        else:
            phase_scale(args.seed, tmp, timings)
            phase_llm(args.seed)
            phase_kernels(args.seed, timings)
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.time() - t_start:.0f} s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
