"""Persistent compile-cache policy (memex_tpu/compile_cache.py)."""

import os

import jax
import pytest

from memex_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config updates instead of applying them: this process
    runs on the CPU backend, where the cache must stay off."""
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    return seen


def test_cpu_backend_keeps_cache_off(updates, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent")
    assert jax.default_backend() == "cpu"
    assert compile_cache.enable_compile_cache() is None
    assert updates == {}


def test_env_dir_is_left_alone(updates, monkeypatch, tmp_path):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in updates


def test_unset_env_uses_fixed_checkout_dir(updates, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache") == compile_cache.DEFAULT_CACHE_DIR
    assert updates["jax_compilation_cache_dir"] == got
    assert os.path.isdir(got)
