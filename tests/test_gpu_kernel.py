"""The fused scan kernel compiled for the card (no interpret mode).

Marked `gpu`: these skip without a CUDA card. Run them on a GPU host with
`MEMEX_TEST_GPU=1 python -m pytest tests/ -m gpu`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from memex_tpu.ops.quant import quantize_rows_int8
from memex_tpu.ops.scan_topk import reference_topk, scan_topk, use_kernel

pytestmark = pytest.mark.gpu


def _corpus(n, d, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((64, d)).astype(np.float32)
    x = cents[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


@pytest.mark.parametrize("mode", ["bf16", "int8q"])
def test_compiled_kernel_matches_reference(gpu_device, mode):
    n, d = 1 << 16, 384
    x = _corpus(n, d)
    with jax.default_device(gpu_device):
        buf = jnp.asarray(x)
        sc = None
        if mode == "int8q":
            buf, sc = quantize_rows_int8(buf)
        q = buf[:64].astype(jnp.float32) if sc is None else jnp.asarray(x[:64])
        kv, ki = scan_topk(buf, q, sc, None, n, 10, mode=mode)
        rv, ri = reference_topk(buf, q, sc, None, n, 10, mode=mode)
    ki, ri = np.asarray(ki), np.asarray(ri)
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ki, ri)])
    assert rec >= 0.99
    # top-1 agrees and its score matches: exactly-computed int32 dots for
    # int8q (float rounding only), bf16 products in f32 sums otherwise
    np.testing.assert_array_equal(ki[:, 0], ri[:, 0])
    tol = dict(rtol=1e-5) if mode == "int8q" else dict(atol=1e-3)
    np.testing.assert_allclose(np.asarray(kv)[:, 0], np.asarray(rv)[:, 0], **tol)


def test_card_selects_the_kernel(gpu_device):
    assert gpu_device.platform == "gpu"
    assert use_kernel("int8q", 10) and use_kernel("bf16", 128)
    assert not use_kernel("exact", 10)
