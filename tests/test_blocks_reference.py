"""The plain-JAX blocks that took over from retired fused kernels, each
against a float64 numpy reference at the kernels' old test shapes: the ViT
block (LN -> attention -> LayerScale residual, LN -> MLP -> LayerScale
residual), the motion modules' GEGLU feed-forward, temporal attention with
its packed K/V cache entry, and the gather resize, with gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import erf

from vdn.nn.motion import (FeedForward, TemporalAttention,
                           sinusoidal_positional_encoding)
from vdn.nn.vit import Block
from vdn.ops.resize import resize2d


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _ln(x, p, eps):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * p["scale"] + p["bias"]


def _lin(x, p):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def _gelu(x):
    return 0.5 * x * (1 + erf(x / np.sqrt(2)))


def _softmax(s):
    s = s - s.max(-1, keepdims=True)
    e = np.exp(s)
    return e / e.sum(-1, keepdims=True)


def _mha(q, k, v, heads):
    """[N, T, C] self-attention over T with C split into heads."""
    n, t, c = q.shape
    sh = lambda a: a.reshape(n, -1, heads, c // heads)
    s = np.einsum("nqhd,nkhd->nhqk", sh(q), sh(k)) * (c // heads) ** -0.5
    return np.einsum("nhqk,nkhd->nqhd", _softmax(s), sh(v)).reshape(n, t, c)


def _block_ref(x, p, heads):
    y = _ln(x, p["norm1"], 1e-6)
    qkv = _lin(y, p["attn"]["qkv"])
    c = x.shape[-1]
    att = _mha(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], heads)
    x = x + _lin(att, p["attn"]["proj"]) * p["ls1"]["gamma"]
    y = _ln(x, p["norm2"], 1e-6)
    y = _lin(_gelu(_lin(y, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return x + y * p["ls2"]["gamma"]


def _perturbed(params, seed):
    """Random non-trivial values for every leaf (LayerScale and LN would
    otherwise start at 1/0)."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(a.shape),
                    jnp.float32) for a in leaves])


# the fused LN->MLP->residual kernel was tested at 640/700 rows, C=256,
# F=1024 (700: a partial last row block)
@pytest.mark.parametrize("b,n", [(2, 320), (1, 700)])
def test_vit_block_matches_float64(b, n):
    c, heads = 256, 4
    x = np.random.default_rng(0).standard_normal((b, n, c)).astype(
        np.float32)
    block = Block(heads)
    params = _perturbed(block.init(jax.random.PRNGKey(0), x), 1)
    got = block.apply(params, jnp.asarray(x))
    want = _block_ref(np.asarray(x, np.float64), _f64(params)["params"],
                      heads)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


def test_vit_block_gradient_matches_finite_difference():
    c, heads = 64, 2
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 40, c))
    cot = rng.standard_normal((1, 40, c))
    block = Block(heads)
    params = _perturbed(block.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 40, c))), 3)
    g = jax.grad(lambda x: jnp.sum(block.apply(params, x) * cot))(
        jnp.asarray(x, jnp.float32))
    p64 = _f64(params)["params"]
    d = rng.standard_normal(x.shape)
    eps = 1e-5
    fd = (np.sum(_block_ref(x + eps * d, p64, heads) * cot)
          - np.sum(_block_ref(x - eps * d, p64, heads) * cot)) / (2 * eps)
    np.testing.assert_allclose(np.sum(np.asarray(g, np.float64) * d), fd,
                               rtol=1e-3)


def _ff_ref(x, p):
    y = _lin(x, p["net_0"]["proj"])
    hidden, gate = np.split(y, 2, axis=-1)
    return _lin(hidden * _gelu(gate), p["net_2"])


@pytest.mark.parametrize("n,c", [(300, 256), (64, 128)])
def test_geglu_feed_forward_matches_float64(n, c):
    x = np.random.default_rng(4).standard_normal((2, n // 2, c)).astype(
        np.float32)
    ff = FeedForward(c)
    params = ff.init(jax.random.PRNGKey(1), x)
    got = ff.apply(params, jnp.asarray(x))
    want = _ff_ref(np.asarray(x, np.float64), _f64(params)["params"])
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


def test_geglu_feed_forward_gradient_matches_finite_difference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8, 32))
    cot = rng.standard_normal((3, 8, 32))
    ff = FeedForward(32)
    params = ff.init(jax.random.PRNGKey(2), jnp.zeros((3, 8, 32)))
    g = jax.grad(lambda x: jnp.sum(ff.apply(params, x) * cot))(
        jnp.asarray(x, jnp.float32))
    p64 = _f64(params)["params"]
    d = rng.standard_normal(x.shape)
    eps = 1e-5
    fd = (np.sum(_ff_ref(x + eps * d, p64) * cot)
          - np.sum(_ff_ref(x - eps * d, p64) * cot)) / (2 * eps)
    np.testing.assert_allclose(np.sum(np.asarray(g, np.float64) * d), fd,
                               rtol=1e-3)


def _temporal_ref(x, p, heads, max_len):
    """APE + q/k/v projections + attention over T + out projection; and
    the packed [K | V | 0] ring entry of the raw inputs."""
    n, t, c = x.shape
    pe = sinusoidal_positional_encoding(c, max_len)[:t].astype(np.float64)
    xp = x + pe[None]
    q, k, v = (xp @ p[nm]["kernel"] for nm in ("to_q", "to_k", "to_v"))
    out = _lin(_mha(q, k, v, heads), p["to_out_0"])
    dh = c // heads
    hv = lambda a: a.reshape(n, t, heads, dh).transpose(2, 0, 1, 3)
    ke, ve = hv(x @ p["to_k"]["kernel"]), hv(x @ p["to_v"]["kernel"])
    width = max(2 * dh, 128)
    pad = np.zeros(ke.shape[:-1] + (width - 2 * dh,))
    entry = np.concatenate([ke, ve, pad], -1).reshape(heads * n, t, width)
    return out, entry


# the fused temporal-attention kernel's shapes: motion-module widths at the
# 32-frame window, and the short training window
@pytest.mark.parametrize("bn,t,c,heads", [
    (300, 32, 256, 8), (64, 32, 1024, 8), (16, 8, 256, 8)])
def test_temporal_attention_matches_float64(bn, t, c, heads):
    x = np.random.default_rng(6).standard_normal((bn, t, c)).astype(
        np.float32)
    attn = TemporalAttention(c, heads, temporal_max_len=32)
    params = _perturbed(attn.init(jax.random.PRNGKey(3), x, t), 7)
    out, entry = attn.apply(params, jnp.asarray(x), t)
    want_out, want_entry = _temporal_ref(np.asarray(x, np.float64),
                                         _f64(params)["params"], heads, 32)
    np.testing.assert_allclose(np.asarray(out), want_out, rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(entry), want_entry, rtol=5e-4,
                               atol=5e-4)


def test_temporal_attention_gradient_matches_finite_difference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((12, 8, 64))
    cot = rng.standard_normal((12, 8, 64))
    attn = TemporalAttention(64, 8, temporal_max_len=32)
    params = _perturbed(attn.init(jax.random.PRNGKey(4),
                                  jnp.zeros((12, 8, 64)), 8), 9)
    g = jax.grad(lambda x: jnp.sum(attn.apply(params, x, 8)[0] * cot))(
        jnp.asarray(x, jnp.float32))
    p64 = _f64(params)["params"]
    d = rng.standard_normal(x.shape)
    eps = 1e-5
    fd = (np.sum(_temporal_ref(x + eps * d, p64, 8, 32)[0] * cot)
          - np.sum(_temporal_ref(x - eps * d, p64, 8, 32)[0] * cot)) \
        / (2 * eps)
    np.testing.assert_allclose(np.sum(np.asarray(g, np.float64) * d), fd,
                               rtol=1e-3)


def _interp_matrix(out_size, in_size, method, align_corners):
    """[out, in] torch-convention interpolation weights, built per output
    index independently of vdn.ops.resize."""
    m = np.zeros((out_size, in_size))
    for o in range(out_size):
        if method == "bilinear":
            if align_corners:
                src = o * (in_size - 1) / max(out_size - 1, 1)
            else:
                src = max((o + 0.5) * in_size / out_size - 0.5, 0.0)
            i0 = int(np.floor(src))
            t = src - i0
            for i, w in ((i0, 1 - t), (i0 + 1, t)):
                m[o, min(max(i, 0), in_size - 1)] += w
        else:  # bicubic, half-pixel, A = -0.75, clamped taps
            src = (o + 0.5) * in_size / out_size - 0.5
            i0 = int(np.floor(src))
            t = src - i0
            a = -0.75
            for j in range(-1, 3):
                x = abs(j - t)
                w = (((a + 2) * x - (a + 3)) * x * x + 1 if x <= 1
                     else ((a * x - 5 * a) * x + 8 * a) * x - 4 * a)
                m[o, min(max(i0 + j, 0), in_size - 1)] += w
    return m


# the retired Pallas resize kernels' shapes: DPT upsamples, a downsample
# band, a non-square map, and the bicubic pos-embed convention
RESIZE_CASES = [((37, 37), (74, 74), "bilinear", True),
                ((74, 74), (37, 37), "bilinear", True),
                ((19, 37), (37, 74), "bilinear", True),
                ((21, 21), (37, 37), "bicubic", False),
                ((21, 30), (37, 64), "bilinear", False)]


@pytest.mark.parametrize("in_hw,out_hw,method,ac", RESIZE_CASES)
def test_resize_matches_float64(in_hw, out_hw, method, ac):
    x = np.random.default_rng(10).standard_normal((2,) + in_hw + (8,))
    got = resize2d(jnp.asarray(x, jnp.float32), out_hw, method, ac)
    mh = _interp_matrix(out_hw[0], in_hw[0], method, ac)
    mw = _interp_matrix(out_hw[1], in_hw[1], method, ac)
    want = np.einsum("oh,bhwc,pw->bopc", mh, x, mw)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_resize_gradient_is_the_transpose():
    in_hw, out_hw = (19, 19), (37, 30)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((1,) + in_hw + (4,)), jnp.float32)
    cot = rng.standard_normal((1,) + out_hw + (4,))
    _, vjp = jax.vjp(lambda x: resize2d(x, out_hw, "bilinear", True), x)
    (g,) = vjp(jnp.asarray(cot, jnp.float32))
    mh = _interp_matrix(out_hw[0], in_hw[0], "bilinear", True)
    mw = _interp_matrix(out_hw[1], in_hw[1], "bilinear", True)
    want = np.einsum("oh,bopc,pw->bhwc", mh, cot, mw)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)
