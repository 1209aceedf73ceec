"""vdn.ops.attention: the XLA path against a float64 numpy reference
(forward and gradients, with and without a key mask), the implementation
choice, and what the wrapper hands cuDNN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vdn.ops import attention
from vdn.ops.attention import choose_implementation, dot_product_attention


def _ref(q, k, v, scale, mask=None):
    """float64 softmax(q k^T * scale) v over [B, T, H, D]."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = np.where(np.asarray(mask), s, -np.inf)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _qkv(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32))


# the shapes the retired fused kernels were tested at: square, wide-K,
# ragged, and multi-head self-attention
@pytest.mark.parametrize("b,tq,tk,h,d", [
    (2, 300, 300, 3, 64), (2, 128, 512, 3, 32), (2, 257, 130, 3, 64),
    (2, 260, 260, 4, 32), (2, 290, 290, 16, 64), (2, 130, 130, 2, 32),
])
def test_forward_matches_float64(b, tq, tk, h, d):
    q, k, v = _qkv(b, tq, tk, h, d)
    got = dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(got), _ref(q, k, v, d ** -0.5),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,tq,tk,h,d,scale", [
    (1, 192, 192, 2, 32, None), (1, 160, 160, 2, 64, 0.1),
    (2, 150, 150, 4, 64, None),
])
def test_gradients_match_float64(b, tq, tk, h, d, scale):
    q, k, v = _qkv(b, tq, tk, h, d, seed=1)
    cot = np.random.default_rng(2).standard_normal(q.shape)
    sc = d ** -0.5 if scale is None else scale

    def loss(q, k, v):
        return jnp.sum(dot_product_attention(q, k, v, scale) * cot)

    got = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    # central finite differences of the float64 reference along a random
    # direction check each gradient
    eps = 1e-4
    for i, g in enumerate(got):
        direction = np.random.default_rng(3 + i).standard_normal(g.shape)
        args = [np.asarray(a, np.float64) for a in (q, k, v)]
        hi, lo = list(args), list(args)
        hi[i] = args[i] + eps * direction
        lo[i] = args[i] - eps * direction
        fd = (np.sum(_ref(*hi, sc) * cot) - np.sum(_ref(*lo, sc) * cot)) \
            / (2 * eps)
        np.testing.assert_allclose(np.sum(np.asarray(g, np.float64)
                                          * direction), fd, rtol=2e-3)


@pytest.mark.parametrize("valid_from", [0, 54, 100])
def test_key_mask_matches_float64(valid_from):
    """Memory-bank slots before ``valid_from`` are masked out."""
    q, k, v = _qkv(1, 54, 162, 2, 16, seed=4)
    mask = (np.arange(162) >= valid_from)[None, None, None, :]
    got = dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                mask=jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(got), _ref(q, k, v, 0.25, mask),
                               rtol=2e-5, atol=2e-5)
    # masked keys do not influence the output at all
    k2, v2 = k.copy(), v.copy()
    k2[:, :valid_from] = 100.0
    v2[:, :valid_from] = -100.0
    got2 = dot_product_attention(*map(jnp.asarray, (q, k2, v2)),
                                 mask=jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(got2), np.asarray(got), atol=1e-6)


def test_bf16_inputs_keep_fp32_softmax():
    q, k, v = _qkv(2, 96, 96, 2, 32, seed=5)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = dot_product_attention(*bf)
    assert got.dtype == jnp.bfloat16
    ref = _ref(*(np.asarray(a, np.float32) for a in bf), 32 ** -0.5)
    err = np.linalg.norm(np.asarray(got, np.float64) - ref) \
        / np.linalg.norm(ref)
    assert err < 1e-2


@pytest.mark.parametrize("platform,dtype,d,tq,tk,masked,want", [
    ("cpu", jnp.bfloat16, 64, 1370, 1370, False, "xla"),
    ("gpu", jnp.bfloat16, 64, 1370, 1370, False, "cudnn"),
    ("gpu", jnp.float16, 64, 1814, 1814, False, "cudnn"),
    ("gpu", jnp.float32, 64, 1370, 1370, False, "xla"),
    ("gpu", jnp.bfloat16, 60, 1370, 1370, False, "xla"),
    ("gpu", jnp.bfloat16, 512, 1370, 1370, False, "xla"),
    ("gpu", jnp.bfloat16, 256, 1370, 1370, False, "cudnn"),
    ("gpu", jnp.bfloat16, 64, 1369, 8214, True, "xla"),
    ("gpu", jnp.bfloat16, 64, 1370, 8220, True, "cudnn"),
    ("gpu", jnp.bfloat16, 64, 1370, 8220, False, "cudnn"),
    ("gpu", jnp.bfloat16, 128, 32, 32, False, "xla"),
    ("gpu", jnp.bfloat16, 64, 4, attention.CUDNN_MIN_KEYS, False, "cudnn"),
])
def test_choose_implementation(platform, dtype, d, tq, tk, masked, want):
    assert choose_implementation(platform, dtype, d, tq, tk, masked) == want


def test_cudnn_gets_full_length_mask(monkeypatch):
    """cuDNN takes the mask as a [.., Tq, Tk] bias; XLA broadcasts."""
    seen = {}

    def fake(q, k, v, mask=None, scale=None, implementation=None):
        seen["mask"], seen["impl"] = mask, implementation
        return q

    monkeypatch.setattr(jax.nn, "dot_product_attention", fake)
    q, k, v = (jnp.zeros((1, 6, 2, 8)), jnp.zeros((1, 10, 2, 8)),
               jnp.zeros((1, 10, 2, 8)))
    mask = jnp.ones((1, 1, 1, 10), bool)
    dot_product_attention(q, k, v, mask=mask, implementation="cudnn")
    assert seen["impl"] == "cudnn" and seen["mask"].shape == (1, 1, 6, 10)
    dot_product_attention(q, k, v, mask=mask, implementation="xla")
    assert seen["impl"] == "xla" and seen["mask"].shape == (1, 1, 1, 10)
    dot_product_attention(q, k, v)
    assert seen["impl"] == "xla"  # CPU
