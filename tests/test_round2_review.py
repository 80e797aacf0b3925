"""Regression tests for the round-2 self-review findings:

1. IVF deleted rows resurrected after a load->save->load cycle (the loaded
   base was filtered in memory but the stale .npz + empty deleted list were
   re-persisted).
2. Flat v2 checkpoints dropped a re-added live row at load (dead tracking
   by id killed every copy, not just the tombstoned one) — dead rows are
   now tracked positionally. Same for ShardedFlatIndex restore.
3. fold_spill un-deleted a cluster-table row when the same id also had a
   tombstoned spill copy.
4. force-recovery re-streamed the whole collection into the spill because
   IVFIndex.add did not dedupe against base ids.
6. /api/fetch broke on relative redirect Locations (no urljoin).
7. /api/fetch had a DNS-rebinding TOCTOU (guard resolved, requests
   re-resolved) — the connection is now pinned to the vetted address.
8. fold_spill leftovers re-inserted via add_quantized invalidated the
   spill's host shadow (degrading future checkpoints to SQL recovery),
   and the host rowid cache was discarded instead of mirrored.
9. Streaming detokenization decoded the FULL sequence per token (O(n^2)).
"""

import threading

import numpy as np
import pytest

from memex_tpu.index import FlatIndex, IVFIndex, ShardedFlatIndex


def unit(rng, n, d):
    v = rng.standard_normal((n, d), dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture
def mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]), ("shard",))


# -- 1: IVF delete must survive repeated checkpoint cycles -------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ivf_delete_survives_two_checkpoint_cycles(rng, tmp_path, dtype):
    d, n = 32, 600
    db = unit(rng, n, d)
    ids = [f"r{i}" for i in range(n)]
    idx = IVFIndex(dim=d, n_clusters=8, nprobe=8, dtype=dtype)
    idx.build(db, ids)
    victim = "r123"
    idx.delete([victim])
    path = str(tmp_path / "ck")
    idx.save(path)

    loaded = IVFIndex.load(path)
    assert victim not in loaded._live
    # The resurrect bug: this save skipped the base rewrite and emptied the
    # deleted list against the stale npz.
    loaded.save(path)
    again = IVFIndex.load(path)
    assert victim not in again._live
    hits = {sid for sid, _ in again.search(db[123:124], 10)[0]}
    assert victim not in hits


# -- 2: delete -> re-add must survive a checkpoint roundtrip -----------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flat_delete_then_readd_roundtrip(rng, tmp_path, dtype):
    d, n = 24, 300
    db = unit(rng, n, d)
    ids = [f"f{i}" for i in range(n)]
    idx = FlatIndex(dim=d, dtype=dtype)
    idx.add(db, ids)
    path = str(tmp_path / "flat")
    idx.save(path)
    new_vec = unit(rng, 1, d)
    idx.delete(["f7"])
    idx.add(new_vec, ["f7"])  # re-add with a NEW vector
    idx.save(path)

    loaded = FlatIndex.load(path)
    # The re-added live row must survive; the tombstoned copy must not.
    assert "f7" in loaded._id_to_row
    hits = loaded.search(new_vec, 3)[0]
    assert hits and hits[0][0] == "f7"
    old_hits = loaded.search(db[7:8], 3)[0]
    got = {sid: v for sid, v in old_hits}
    # The OLD vector's row is gone: f7 may appear only via the new vector's
    # (much lower) similarity against the old query, never at ~1.0.
    if "f7" in got and dtype == "float32":
        assert got["f7"] < 0.9


def test_sharded_delete_then_readd_restore(rng, tmp_path, mesh):
    d, n = 16, 200
    db = unit(rng, n, d)
    ids = [f"s{i}" for i in range(n)]
    idx = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=512)
    idx.add(db, ids)
    path = str(tmp_path / "sh")
    idx.save(path)
    new_vec = unit(rng, 1, d)
    idx.delete(["s5"])
    idx.add(new_vec, ["s5"])
    idx.save(path)

    fresh = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=512)
    restored = fresh.restore(path)
    assert restored == n  # n-1 originals + the re-added row
    assert "s5" in fresh._id_to_row
    hits = fresh.search(new_vec, 3)[0]
    assert hits and hits[0][0] == "s5"


def test_sharded_restore_drops_only_the_dead_copy(rng, tmp_path, mesh):
    d, n = 16, 120
    db = unit(rng, n, d)
    idx = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=256)
    idx.add(db, [f"x{i}" for i in range(n)])
    path = str(tmp_path / "sh2")
    idx.save(path)
    idx.delete(["x3", "x99"])
    idx.save(path)
    fresh = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=256)
    assert fresh.restore(path) == n - 2
    assert "x3" not in fresh._id_to_row and "x99" not in fresh._id_to_row
    # Restore renumbers rows, so the log must NOT resume in place — the
    # next save rewrites and a fresh restore still agrees.
    fresh.delete(["x42"])
    fresh.save(path)
    third = ShardedFlatIndex(dim=d, mesh=mesh, capacity_per_shard=256)
    assert third.restore(path) == n - 3
    assert "x42" not in third._id_to_row


# -- 3 + re-add semantics for IVF --------------------------------------------


def test_ivf_delete_sticks_through_fold_spill(rng):
    d, n = 16, 400
    db = unit(rng, n, d)
    ids = [f"v{i}" for i in range(n)]
    idx = IVFIndex(dim=d, n_clusters=4, nprobe=4, dtype="int8")
    idx.build(db, ids)
    idx.delete(["v10"])
    idx.add(unit(rng, 30, d), [f"new{i}" for i in range(30)])
    idx.fold_spill()
    # v10 had no spill copy, but fold_spill used to subtract every dropped
    # spill id from _deleted; the invariant is that a deleted id with a
    # live table row STAYS deleted until rebuild.
    assert "v10" in idx._deleted
    hits = {sid for sid, _ in idx.search(db[10:11], 10)[0]}
    assert "v10" not in hits


def test_ivf_readd_after_delete_is_live(rng, tmp_path):
    d, n = 16, 400
    db = unit(rng, n, d)
    ids = [f"v{i}" for i in range(n)]
    idx = IVFIndex(dim=d, n_clusters=4, nprobe=4)
    idx.build(db, ids)
    idx.delete(["v20"])
    new_vec = unit(rng, 1, d)
    idx.add(new_vec, ["v20"])
    assert "v20" not in idx._deleted and "v20" in idx._live
    hits = idx.search(new_vec, 3)[0]
    assert hits and hits[0][0] == "v20"
    # The stale table copy must not shadow the new row after a roundtrip.
    path = str(tmp_path / "ivf")
    idx.save(path)
    loaded = IVFIndex.load(path)
    hits = loaded.search(new_vec, 3)[0]
    assert hits and hits[0][0] == "v20"
    old = {sid: v for sid, v in loaded.search(db[20:21], 5)[0]}
    if "v20" in old:
        assert old["v20"] < 0.9  # the old ~1.0-similarity copy is dead


# -- 4: adds are idempotent (recovery can re-stream safely) ------------------


def test_ivf_add_dedupes_against_base(rng):
    d, n = 16, 400
    db = unit(rng, n, d)
    ids = [f"b{i}" for i in range(n)]
    idx = IVFIndex(dim=d, n_clusters=4, nprobe=4)
    idx.build(db, ids)
    spill_before = idx.spill.count
    idx.add(db, ids)  # force-recovery replays the whole collection
    assert idx.spill.count == spill_before  # nothing duplicated
    assert idx.count == n


# -- 6/7: fetch guard ---------------------------------------------------------


class _RedirServer:
    """Tiny local HTTP server: /start 302s to a RELATIVE /body; /loop
    redirects forever; /big serves > the cap."""

    def __init__(self):
        import http.server

        test = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                test.paths.append(self.path)
                test.hosts.append(self.headers.get("Host"))
                if self.path == "/start":
                    self.send_response(302)
                    self.send_header("Location", "/body")  # relative!
                    self.end_headers()
                elif self.path == "/loop":
                    self.send_response(302)
                    self.send_header("Location", "/loop")
                    self.end_headers()
                elif self.path == "/big":
                    data = b"x" * 4096
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    body = "hello fetched".encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self.paths: list[str] = []
        self.hosts: list[str] = []
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def redir_server():
    srv = _RedirServer()
    yield srv
    srv.stop()


def _local_resolver(host, port, proto=None):
    # The pinned-connect path under test: the guard must connect to THIS
    # answer, not re-resolve.
    import socket

    return [(socket.AF_INET, socket.SOCK_STREAM, proto, "",
             ("127.0.0.1", port))]


def test_fetch_follows_relative_redirects(redir_server, monkeypatch):
    monkeypatch.setenv("MEMEX_FETCH_ALLOW_PRIVATE", "1")
    from memex_tpu.api.fetch_guard import guarded_fetch

    out = guarded_fetch(f"http://svc.internal:{redir_server.port}/start",
                        resolver=_local_resolver)
    assert out == "hello fetched"
    assert redir_server.paths == ["/start", "/body"]
    # Pinning: the socket went to the resolver's answer while the Host
    # header carried the original name.
    assert redir_server.hosts[0] == f"svc.internal:{redir_server.port}"


def test_fetch_redirect_loop_bounded(redir_server, monkeypatch):
    monkeypatch.setenv("MEMEX_FETCH_ALLOW_PRIVATE", "1")
    from memex_tpu.api.fetch_guard import guarded_fetch

    with pytest.raises(ValueError, match="too many redirects"):
        guarded_fetch(f"http://svc.internal:{redir_server.port}/loop",
                      max_redirects=3, resolver=_local_resolver)


def test_fetch_size_cap(redir_server, monkeypatch):
    monkeypatch.setenv("MEMEX_FETCH_ALLOW_PRIVATE", "1")
    from memex_tpu.api.fetch_guard import guarded_fetch

    with pytest.raises(ValueError, match="exceeds"):
        guarded_fetch(f"http://svc.internal:{redir_server.port}/big",
                      max_bytes=1024, resolver=_local_resolver)


def test_fetch_guard_blocks(monkeypatch):
    monkeypatch.delenv("MEMEX_FETCH_ALLOW_PRIVATE", raising=False)
    from memex_tpu.api.fetch_guard import vet_target

    with pytest.raises(ValueError, match="scheme"):
        vet_target("file:///etc/passwd")
    with pytest.raises(ValueError, match="missing host"):
        vet_target("http://")
    # The guard's ONE resolution decides: an attacker-controlled name
    # resolving to loopback/metadata is blocked outright.
    with pytest.raises(ValueError, match="not a public"):
        vet_target("http://evil.example/", resolver=_local_resolver)

    def meta_resolver(host, port, proto=None):
        import socket

        return [(socket.AF_INET, socket.SOCK_STREAM, proto, "",
                 ("169.254.169.254", port))]

    with pytest.raises(ValueError, match="not a public"):
        vet_target("http://evil.example/", resolver=meta_resolver)

    def pub_resolver(host, port, proto=None):
        import socket

        return [(socket.AF_INET, socket.SOCK_STREAM, proto, "",
                 ("93.184.216.34", port))]

    parsed, host, port, ip = vet_target("https://ok.example/x",
                                        resolver=pub_resolver)
    assert (host, port, ip) == ("ok.example", 443, "93.184.216.34")


# -- 8: fold_spill keeps host shadows intact ----------------------------------


def test_fold_spill_preserves_spill_shadow_and_rowids(rng):
    d = 16
    idx = IVFIndex(dim=d, n_clusters=4, nprobe=4, dtype="int8",
                   bucket_factor=1.0)
    n = 400
    idx.build(unit(rng, n, d), [f"h{i}" for i in range(n)])
    assert idx._host_data is not None  # host-built
    M = idx.data.shape[1]
    capacity = 4 * M
    # Overfill: more spill rows than total free bucket slots guarantees
    # fold leftovers.
    extra = capacity  # >> free slots
    idx.add(unit(rng, extra, d), [f"e{i}" for i in range(extra)])
    assert idx.rowids is not None
    idx.fold_spill()
    assert idx.spill.count > 0, "test needs leftovers to be meaningful"
    # The leftover rows came through the host — the shadow must survive
    # (otherwise every future checkpoint degrades to rows_skipped).
    assert idx.spill._sh_valid
    # The host rowid cache was mirrored, not discarded.
    assert idx.rowids is not None
    np.testing.assert_array_equal(
        idx.rowids, np.asarray(idx._rowids_dev).astype(np.int64))


# -- 9: streaming detokenization does bounded work ----------------------------


def test_stream_detokenize_bounded_and_lossless():
    from memex_tpu.llm.base import ChatMessage, ChatRole
    from memex_tpu.llm.local import LocalLLM

    llm = LocalLLM.tiny(seed=3)
    windows = []
    inner = llm.tokenizer.decode

    def spy(ids):
        windows.append(len(ids))
        return inner(ids)

    llm.tokenizer.decode = spy
    pieces: list[str] = []
    out = llm.chat_completion(
        "tiny", [ChatMessage(ChatRole.User, "count")],
        on_token=pieces.append, max_new=48,
    )
    llm.tokenizer.decode = inner
    # Lossless: the emitted stream IS the final text.
    assert "".join(pieces) == out
    # Bounded: cumulative decode work is O(n), not O(n^2). The old code
    # decoded the full prefix per token (sum = n(n+1)/2 = 1176 here); the
    # incremental scheme pays a few tokens per step plus ONE final
    # full-sequence decode for the return value.
    n = 48
    assert windows and sum(windows) < 8 * n
    # And at most one call (the final return) sees the whole sequence.
    assert sum(1 for w in windows if w > n // 2) <= 2


# -- legacy checkpoint compatibility ------------------------------------------


def test_flat_legacy_dead_ids_meta_still_loads(rng, tmp_path):
    """Pre-round-2 v2 checkpoints carried dead_ids (id-keyed tombstones);
    load must still honor them."""
    import json

    d, n = 16, 40
    idx = FlatIndex(dim=d)
    idx.add(unit(rng, n, d), [f"L{i}" for i in range(n)])
    path = str(tmp_path / "legacy")
    idx.save(path)
    meta = json.load(open(path + ".meta.json"))
    assert meta["dead_rows"] == []
    del meta["dead_rows"]
    meta["dead_ids"] = ["L4", "L9"]  # rewrite as an old checkpoint
    json.dump(meta, open(path + ".meta.json", "w"))
    loaded = FlatIndex.load(path)
    assert loaded.count == n - 2
    assert "L4" not in loaded._id_to_row and "L9" not in loaded._id_to_row


# -- delete-churn maintenance -------------------------------------------------


def test_ivf_store_delete_churn_triggers_rebuild(rng, tmp_path):
    """Tombstones persist until rebuild (they must — fold cannot un-mark
    them) and widen every search's over-fetch; the store must bound that
    by rebuilding once >25% of rows are dead."""
    from memex_tpu.store.base import VectorData
    from memex_tpu.store.tpu_store import TpuIVFStore

    d, n = 16, 2048
    store = TpuIVFStore(str(tmp_path), "churn", dim=d, n_clusters=4,
                        nprobe=4)
    vecs = unit(rng, n, d)
    store.build([VectorData(id=f"c{i}", document_id="doc", text="",
                            vector=vecs[i], segment_id=i) for i in range(n)])
    # Delete 30% — crosses the 25% churn threshold (and the 256 floor).
    store.delete([f"c{i}" for i in range(614)])
    assert len(store.index._deleted) == 0, "rebuild should clear tombstones"
    assert store.count == n - 614
    hits = store.search(vecs[0], 3)
    assert all(h.id != "c0" for h in hits)
    live_hit = store.search(vecs[700], 1)[0]
    assert live_hit.id == "c700"
