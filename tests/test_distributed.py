"""Multi-host bring-up test: two real OS processes initialize
jax.distributed through parallel/distributed.init_multihost and compute a
global reduction over a cross-process mesh (SURVEY.md §2.3 item 4 — the
replacement for an NCCL/MPI bootstrap). Runs hermetically on
CPU via gloo collectives."""

import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)  # one device per process
    import jax
    jax.config.update("jax_platforms", "cpu")
    coord, pid, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, repo)
    from memex_tpu.parallel.distributed import init_multihost
    assert init_multihost(coord, 2, pid)
    assert jax.process_count() == 2
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    devs = np.array(jax.devices())
    assert len(jax.local_devices()) < len(devs)  # mesh spans both processes
    mesh = Mesh(devs, ("d",))
    x = jax.device_put(jnp.ones((len(devs),), jnp.float32), NamedSharding(mesh, P("d")))
    total = float(jax.jit(jnp.sum)(x))  # cross-process reduction
    assert total == float(len(devs)), total
    print(f"OK {pid} {total}")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_psum(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    assert any("OK 0" in o for o in outs) and any("OK 1" in o for o in outs)


WORKER_SEARCH = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)  # one device per process
    import jax
    jax.config.update("jax_platforms", "cpu")
    coord, pid, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, repo)
    from memex_tpu.parallel.distributed import init_multihost
    assert init_multihost(coord, 2, pid)
    import numpy as np
    from jax.sharding import Mesh
    from memex_tpu.index.sharded import ShardedFlatIndex
    devs = np.array(jax.devices())
    assert len(devs) == 2 and len(jax.local_devices()) == 1
    mesh = Mesh(devs, ("shard",))
    # Identical deterministic corpus on both processes (multi-controller
    # SPMD contract: every process runs the same program on the same data).
    rng = np.random.default_rng(7)
    db = rng.standard_normal((64, 32)).astype("float32")
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    idx = ShardedFlatIndex(dim=32, mesh=mesh, capacity_per_shard=64,
                           dtype="int8")
    idx.add(db, [f"v{i}" for i in range(64)])
    assert sum(idx.counts) == 64 and min(idx.counts) > 0  # both shards hold rows
    # The search executes per-shard scans + an all_gather top-k merge over
    # the cross-process mesh; results are replicated to both hosts.
    hits = idx.search(db[:4], k=3)
    for i in range(4):
        assert hits[i][0][0] == f"v{i}", (pid, hits[i])
    idx.delete(["v1"])
    hits = idx.search(db[1:2], k=3)
    assert hits[0][0][0] != "v1", (pid, hits[0])
    print(f"SEARCH-OK {pid}")
    """
)


def test_two_process_sharded_search_over_dcn(tmp_path):
    """Round-2 VERDICT item 10: beyond a psum — a sharded-index search
    with collective merge across two real OS processes (the multi-host
    topology; gloo on CPU stands in for the device collectives)."""
    worker = tmp_path / "worker_search.py"
    worker.write_text(WORKER_SEARCH)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    assert any("SEARCH-OK 0" in o for o in outs)
    assert any("SEARCH-OK 1" in o for o in outs)


def test_init_multihost_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("MEMEX_COORDINATOR", raising=False)
    from memex_tpu.parallel.distributed import init_multihost

    assert init_multihost() is False
