"""End-to-end pipeline parity vs the reference inference protocols:
windowed clip stitching, streaming decode, stateful single-image memory."""

import numpy as np
import pytest
import torch

from tests import _reference

_reference.add_reference_to_path()

from video_depth_anything.video_depth import (  # noqa: E402
    VideoDepthAnything as RefVDAClip)
from video_depth_anything.video_depth_stream import (  # noqa: E402
    VideoDepthAnything as RefVDAStream)
from depth_anything_v2.depth_anything_v2 import (  # noqa: E402
    DepthAnythingV2 as RefDA2)

from vdn.core.convert import convert_torch_state  # noqa: E402
from vdn.models.depth_anything_v2 import DepthAnythingV2  # noqa: E402
from vdn.models.video_depth_anything import VideoDepthAnything  # noqa: E402
from vdn.pipelines.infer_image import DepthAnythingV2Pipeline  # noqa: E402
from vdn.pipelines.infer_video import infer_video_depth  # noqa: E402
from vdn.pipelines.stream import VideoDepthStreamPipeline  # noqa: E402

CFG = dict(encoder="vits", features=64, out_channels=[48, 96, 192, 384])


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


@pytest.mark.slow
def test_windowed_video_matches():
    torch.manual_seed(0)
    ref = RefVDAClip(**CFG).eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = VideoDepthAnything(encoder="vits", features=64,
                               out_channels=(48, 96, 192, 384))
    frames = _frames(40, 64, 88)
    with torch.no_grad():
        ref_depths, _ = ref.infer_video_depth(frames, 24, input_size=56,
                                              device="cpu", fp32=True)
    got, fps = infer_video_depth(model, params, frames, 24, input_size=56)
    assert got.shape == ref_depths.shape == (40, 64, 88)
    np.testing.assert_allclose(got, ref_depths, rtol=1e-3, atol=2e-3)


@pytest.mark.slow
def test_windowed_encoder_cache_exact():
    """The cross-window encoder-feature cache (the default path) must
    reproduce the plain re-encode-every-window path: the ViT encoder is
    frame-independent, so the KEYFRAMES seed frames' features are the
    same whether gathered from the previous window or recomputed
    (tolerance covers batch-tiling float noise only)."""
    model = VideoDepthAnything(encoder="vits", features=64,
                               out_channels=(48, 96, 192, 384))
    frames = _frames(40, 64, 88, seed=2)
    import jax
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), np.zeros((1, 2, 56, 56, 3), np.float32))
    got_cached, _ = infer_video_depth(model, params, frames, 24,
                                      input_size=56)
    got_plain, _ = infer_video_depth(model, params, frames, 24,
                                     input_size=56, cache_encoder=False)
    np.testing.assert_allclose(got_cached, got_plain, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_streaming_matches():
    torch.manual_seed(0)
    ref = RefVDAStream(**CFG).eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = VideoDepthAnything(encoder="vits", features=64,
                               out_channels=(48, 96, 192, 384))
    pipe = VideoDepthStreamPipeline(model, params, input_size=56)
    frames = _frames(14, 64, 64, seed=3)
    for i in range(14):
        with torch.no_grad():
            ref_d = ref.infer_video_depth_one(frames[i], input_size=56,
                                              device="cpu", fp32=True)
        got_d = pipe.infer_video_depth_one(frames[i])
        np.testing.assert_allclose(got_d, ref_d, rtol=1e-3, atol=2e-3,
                                   err_msg=f"frame {i}")
    # the eviction policy must have kicked in by frame 13
    assert len(pipe.slots) < 14 + 32


def test_infer_image_stateful_matches():
    torch.manual_seed(0)
    ref = RefDA2(**CFG).eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = DepthAnythingV2(encoder="vits", features=64,
                            out_channels=(48, 96, 192, 384))
    pipe = DepthAnythingV2Pipeline(model, params)
    # NOTE: the memory RoPE path is square-grid only — the reference asserts
    # on non-square inputs (sam2 position_encoding.py:207 via
    # sam/transformer.py:287 w = h = sqrt(N)); we inherit that constraint.
    frames = _frames(2, 70, 70, seed=5)
    ref.clear_memory()
    for i in range(2):
        with torch.no_grad():
            ref_d = ref.infer_image(frames[i], input_size=56)
        got_d = pipe.infer_image(frames[i], input_size=56)
        assert got_d.shape == ref_d.shape == (70, 70)
        np.testing.assert_allclose(got_d, ref_d, rtol=1e-3, atol=2e-3,
                                   err_msg=f"frame {i}")


def test_streaming_chunked_matches_per_frame():
    """Micro-batched decode (chunk_size>1) must be numerically identical to
    the per-frame path — the scan replays per-frame cache semantics."""
    import jax
    import jax.numpy as jnp

    model = VideoDepthAnything(encoder="vits", features=64,
                               out_channels=(48, 96, 192, 384))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 2, 56, 56, 3), jnp.float32))
    frames = _frames(13, 64, 64, seed=5)

    pipe1 = VideoDepthStreamPipeline(model, params, input_size=56)
    ref_out = [pipe1.infer_video_depth_one(f) for f in frames]

    pipe2 = VideoDepthStreamPipeline(model, params, input_size=56)
    got = []
    got += pipe2.infer_video_depth_chunk(list(frames[:5]))   # first + 4
    got += pipe2.infer_video_depth_chunk(list(frames[5:9]))
    got += pipe2.infer_video_depth_chunk(list(frames[9:]))

    assert len(got) == len(ref_out)
    for i, (a, b) in enumerate(zip(got, ref_out)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg=f"frame {i}")
    assert pipe1.slots == pipe2.slots and pipe1.free == pipe2.free
