"""Persistent XLA compile-cache policy, shared by serve, bench and entry.

One implementation so the policy cannot drift between call sites:
  - `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself; leave it alone
    and set no other directory;
  - otherwise: a fixed directory inside the checkout, `<repo>/.jax_cache`
    (listed in .gitignore). The path is part of the cache key, so it must
    not move between runs;
  - never on the CPU backend: XLA:CPU entries can reload with
    machine-feature mismatches ("prefer-no-gather is not supported on the
    host machine") that silently degrade cached ops with SIGILL risk.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Configure the persistent cache; returns its directory, or None on
    the CPU backend. Safe to call repeatedly. Errors propagate: a device
    process that silently ran without its cache would recompile every
    executable on every start."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return DEFAULT_CACHE_DIR
