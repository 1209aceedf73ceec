"""VideoDepthAnything (clip + cached streaming decode) parity vs reference."""

import numpy as np
import pytest
import torch

from tests import _reference

_reference.add_reference_to_path()

from video_depth_anything.video_depth import (  # noqa: E402
    VideoDepthAnything as RefVDA)
from video_depth_anything import video_depth_stream as ref_stream  # noqa: E402

from vdn.core.convert import convert_torch_state  # noqa: E402
from vdn.models.video_depth_anything import VideoDepthAnything  # noqa: E402

CFG = dict(encoder="vits", features=64, out_channels=[48, 96, 192, 384])


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    ref = RefVDA(**CFG).eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = VideoDepthAnything(encoder="vits", features=64,
                               out_channels=(48, 96, 192, 384))
    return ref, model, params


def test_clip_forward_matches(pair):
    ref, model, params = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 56, 56, 3)).astype(np.float32)
    with torch.no_grad():
        ref_out = ref(torch.from_numpy(
            np.moveaxis(x, -1, 2).copy())).numpy()
    got = np.asarray(model.apply(params, x))
    assert got.shape == ref_out.shape == (1, 4, 56, 56)
    np.testing.assert_allclose(got, ref_out, rtol=1e-3, atol=5e-4)


def test_streaming_cached_decode_matches(pair):
    """Single-frame decode with a KV cache must match the reference
    stream path (video_depth_stream.py:127-152)."""
    torch.manual_seed(0)
    ref = ref_stream.VideoDepthAnything(**CFG).eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = VideoDepthAnything(encoder="vits", features=64,
                               out_channels=(48, 96, 192, 384))

    rng = np.random.default_rng(1)
    window = rng.standard_normal((1, 3, 56, 56, 3)).astype(np.float32)
    new_frame = rng.standard_normal((1, 1, 56, 56, 3)).astype(np.float32)

    wt = torch.from_numpy(np.moveaxis(window, -1, 2).copy())
    nt = torch.from_numpy(np.moveaxis(new_frame, -1, 2).copy())

    with torch.no_grad():
        feats = ref.forward_features(wt)
        _, ref_caches = ref.forward_depth(feats, wt.shape)
        feats1 = ref.forward_features(nt)
        ref_depth, ref_new = ref.forward_depth(
            feats1, nt.shape, cached_hidden_state_list=list(ref_caches))

    def run_window(m, x):
        f = m.forward_features(x)
        return m.forward_depth(f, x.shape)

    def run_cached(m, x, caches):
        f = m.forward_features(x)
        return m.forward_depth(f, x.shape, caches=caches)

    _, caches = model.apply(params, window, method=run_window)
    got_depth, got_new = model.apply(params, new_frame, caches,
                                     method=run_cached)

    assert len(caches) == len(ref_caches) == 8
    np.testing.assert_allclose(np.asarray(got_depth),
                               ref_depth.numpy(), rtol=1e-3, atol=5e-4)
    for g, r in zip(got_new, ref_new):
        np.testing.assert_allclose(np.asarray(g), r.numpy(),
                                   rtol=1e-3, atol=5e-4)


def test_remat_head_matches_unremat():
    """remat=True must be numerically identical (forward AND grads) while
    rematerializing the refinenet tail on backward."""
    import jax
    import jax.numpy as jnp
    from vdn.models.video_depth_anything import VideoDepthAnything

    cfg = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64))
    x = np.random.default_rng(0).standard_normal(
        (1, 2, 56, 56, 3)).astype(np.float32)
    m0 = VideoDepthAnything(**cfg, remat=False)
    m1 = VideoDepthAnything(**cfg, remat=True)
    params = m0.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(m, p):
        return (m.apply(p, jnp.asarray(x)) ** 2).sum()

    l0, g0 = jax.value_and_grad(lambda p: loss(m0, p))(params)
    l1, g1 = jax.value_and_grad(lambda p: loss(m1, p))(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
