"""Preprocessing without cv2: the bicubic resize (vdn.ops.resize's plan,
run by XLA) equals cv2's INTER_CUBIC on float32, frame stacks preprocess
like single frames, and BGR input is flipped to RGB."""

import jax.numpy as jnp
import numpy as np
import pytest

from vdn.ops.resize import resize2d
from vdn.pipelines.transform import (IMAGENET_MEAN, IMAGENET_STD,
                                     compute_resize_hw, image2tensor_bgr,
                                     preprocess_frame, preprocess_frames)

cv2 = pytest.importorskip("cv2")


# common video aspect ratios, up- and down-scaling, odd sizes
@pytest.mark.parametrize("h,w,oh,ow", [
    (480, 640, 518, 686),     # 4:3 -> the pipeline's working size
    (720, 1280, 518, 924),    # 16:9
    (1080, 1920, 518, 924),   # 16:9 downscale
    (640, 480, 686, 518),     # portrait
    (300, 300, 518, 518),     # square upscale
    (37, 53, 100, 40),        # mixed up/down per axis
    (10, 7, 3, 5),            # tiny: clamped taps on both borders
    (33, 33, 33, 33),         # identity size
])
def test_resize_matches_cv2_inter_cubic(h, w, oh, ow):
    img = np.random.default_rng(h * w).random((h, w, 3), dtype=np.float32)
    got = np.asarray(resize2d(jnp.asarray(img)[None], (oh, ow),
                              "bicubic"))[0]
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_preprocess_frame_matches_cv2_pipeline():
    frame = np.random.default_rng(1).integers(0, 256, (480, 640, 3),
                                              dtype=np.uint8)
    got = preprocess_frame(frame, 518)
    h, w = compute_resize_hw(480, 640, 518)
    img = cv2.resize(frame.astype(np.float32) / 255.0, (w, h),
                     interpolation=cv2.INTER_CUBIC)
    want = (img - IMAGENET_MEAN) / IMAGENET_STD
    assert got.shape == (518, 686, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bgr_input_is_flipped_to_rgb():
    bgr = np.random.default_rng(2).integers(0, 256, (60, 80, 3),
                                            dtype=np.uint8)
    x, hw = image2tensor_bgr(bgr, 56)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    assert hw == (60, 80)
    np.testing.assert_allclose(x[0], preprocess_frame(rgb, 56), atol=1e-6)


def test_frame_stack_matches_single_frames():
    frames = np.random.default_rng(3).integers(0, 256, (3, 45, 60, 3),
                                               dtype=np.uint8)
    stack = np.asarray(preprocess_frames(frames, 56))
    for f, got in zip(frames, stack):
        np.testing.assert_array_equal(got, preprocess_frame(f, 56))
