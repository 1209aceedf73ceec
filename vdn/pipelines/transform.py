"""Preprocessing, matching the reference transforms.

The reference preprocesses on CPU with cv2 (reference
depth_anything_v2/util/transform.py:5-157); resize math must match or
depth-metric parity drifts.  Here the resize is vdn.ops.resize's separable
bicubic plan, which is cv2's INTER_CUBIC convention on float32 (A = -0.75,
half-pixel centres, clamped taps; equal to cv2 to float32 rounding,
tests/test_transform.py), run as one jitted op per frame stack on the
default device, so a window's frames are resized where the model runs.

Layout difference: vdn is NHWC, so PrepareForNet's HWC->CHW transpose
disappears.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vdn.ops.resize import resize2d

__all__ = ["compute_resize_hw", "preprocess_frame", "preprocess_frames",
           "image2tensor_bgr",
           "IMAGENET_MEAN", "IMAGENET_STD", "adjust_input_size_for_ratio"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _constrain_to_multiple_of(x: float, multiple: int, min_val: int = 0
                              ) -> int:
    y = int(np.round(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def compute_resize_hw(height: int, width: int, target: int = 518,
                      multiple: int = 14) -> Tuple[int, int]:
    """'lower_bound' keep-aspect size selection
    (reference util/transform.py:62-107): scale so both sides >= target,
    rounded to a multiple of 14."""
    scale_h = target / height
    scale_w = target / width
    scale = max(scale_w, scale_h)
    new_h = _constrain_to_multiple_of(scale * height, multiple,
                                     min_val=target)
    new_w = _constrain_to_multiple_of(scale * width, multiple,
                                     min_val=target)
    return new_h, new_w


def adjust_input_size_for_ratio(height: int, width: int,
                                input_size: int = 518) -> int:
    """>16:9 inputs shrink the working size
    (reference video_depth_anything/video_depth.py:69-72)."""
    ratio = max(height, width) / min(height, width)
    if ratio > 1.78:
        input_size = int(input_size * 1.777 / ratio)
        input_size = round(input_size / 14) * 14
    return input_size


@functools.partial(jax.jit, static_argnums=(1,))
def _preprocess(frames, hw: Tuple[int, int]):
    x = resize2d(frames.astype(jnp.float32) / 255.0, hw, "bicubic")
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def preprocess_frames(frames, input_size: int = 518) -> jax.Array:
    """[T, H, W, 3] uint8/float RGB frames (0-255) -> normalized fp32
    [T, h, w, 3] network input on the default device (bicubic resize to
    the lower-bound size + ImageNet normalization)."""
    frames = jnp.asarray(frames)
    hw = compute_resize_hw(frames.shape[1], frames.shape[2], input_size)
    return _preprocess(frames, hw)


def preprocess_frame(frame_rgb: np.ndarray, input_size: int = 518
                     ) -> np.ndarray:
    """One HWC RGB frame -> normalized fp32 [h, w, 3] (host array)."""
    return np.asarray(preprocess_frames(frame_rgb[None], input_size)[0])


def image2tensor_bgr(raw_bgr: np.ndarray, input_size: int = 518
                     ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """BGR image (cv2.imread convention) -> ([1, h, w, 3], original (H, W))
    (reference depth_anything_v2.py:67-92)."""
    h, w = raw_bgr.shape[:2]
    rgb = raw_bgr[..., ::-1]
    return preprocess_frame(rgb, input_size)[None], (h, w)
