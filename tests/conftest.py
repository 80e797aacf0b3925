"""Test harness config.

Force JAX onto a virtual 8-device CPU mesh BEFORE jax is imported anywhere,
so sharding/collective tests exercise real multi-device paths without
accelerator hardware ("test multi-node without a real cluster",
SURVEY.md §4).
"""

import os
import sys

# Hard override: the shell env may pin JAX_PLATFORMS to an accelerator
# (e.g. "cuda"); tests must stay hermetic and fast on virtual CPU devices.
# MEMEX_TEST_GPU=1 (with `-m gpu`) keeps the CUDA backend for the tests
# that need a card; the `gpu_device` fixture skips them without one.
_PLATFORMS = "cuda,cpu" if os.environ.get("MEMEX_TEST_GPU") == "1" else "cpu"
os.environ["JAX_PLATFORMS"] = _PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Repo root on sys.path so `import memex_tpu` works without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# A site plugin may have force-registered a hardware backend and overridden
# jax_platforms at interpreter startup; flip back to the virtual CPU mesh.
import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", _PLATFORMS)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when there is none. Decided
    here, at run time, never while a module is imported."""
    try:
        devs = jax.devices("cuda")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA card (run with MEMEX_TEST_GPU=1 -m gpu)")
    return devs[0]
