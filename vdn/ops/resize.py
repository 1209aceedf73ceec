"""Torch-exact 2-D interpolation for NHWC tensors.

The reference leans on ``torch.nn.functional.interpolate`` in four places that
are all on the accuracy-critical path (see reference ``depth_anything_v2/dpt.py:147``,
``util/blocks.py:144``, ``dinov2.py:199-205``, ``video_depth_anything/video_depth.py:63``):

- bilinear ``align_corners=True`` (DPT fusion upsamples + final depth resize)
- bicubic ``align_corners=False`` with an explicit ``scale_factor``
  (positional-embedding interpolation, torch cubic kernel A = -0.75)
- nearest (dataset target resizing)

``jax.image.resize`` matches none of these conventions (half-pixel only,
Catmull-Rom cubic A=-0.5), so we build the interpolation as a static-shape
gather + weighted sum per axis: for each output index we precompute (numpy,
at trace time) the source tap indices and weights exactly the way torch does,
then apply them with ``jnp.take``.  Cost is O(taps x elements); the gather
and the weighted sum are parallel kernels that XLA fuses with their
neighbours.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


__all__ = ["resize2d", "interpolate_like_torch"]


def _source_coords(out_size: int, in_size: int, align_corners: bool,
                   scale: Optional[float], cubic: bool) -> np.ndarray:
    """Fractional source coordinate for each output index (torch convention)."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size <= 1:
            return np.zeros((out_size,), dtype=np.float64)
        return dst * (in_size - 1) / (out_size - 1)
    # half-pixel; when an explicit scale_factor was given torch uses it
    # directly instead of out/in (recompute_scale_factor=None semantics)
    inv_scale = (1.0 / scale) if scale is not None else (in_size / out_size)
    src = (dst + 0.5) * inv_scale - 0.5
    if not cubic:
        # torch clamps the source index at 0 for linear (not for cubic)
        src = np.maximum(src, 0.0)
    return src


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Torch's 4-tap cubic convolution weights for fractional offset t."""
    # taps at offsets (-1, 0, 1, 2) relative to floor(src)
    def k1(x):  # |x| in [0, 1]
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k2(x):  # |x| in [1, 2]
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return np.stack([k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)], axis=-1)


@functools.lru_cache(maxsize=256)
def _plan_axis(out_size: int, in_size: int, method: str, align_corners: bool,
               scale: Optional[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute (indices [out, taps] int32, weights [out, taps] f32)."""
    if method == "bilinear_aa":
        # torch antialiased bilinear (F.interpolate(..., antialias=True),
        # aten UpSampleKernel _compute_indices_weights_aa): triangle filter
        # widened by the downsampling factor, weights normalized per output.
        # For upsampling the formula degenerates to standard half-pixel
        # bilinear, so one plan covers both directions.
        s = in_size / out_size
        support = s if s > 1.0 else 1.0
        inv = (1.0 / s) if s > 1.0 else 1.0
        max_taps = int(np.ceil(support)) * 2 + 1
        idx = np.zeros((out_size, max_taps), np.int64)
        w = np.zeros((out_size, max_taps), np.float64)
        for o in range(out_size):
            center = s * (o + 0.5)
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            for j in range(xmax - xmin):
                arg = (j + xmin - center + 0.5) * inv
                w[o, j] = max(0.0, 1.0 - abs(arg))
                idx[o, j] = xmin + j
            tot = w[o].sum()
            if tot > 0:
                w[o] /= tot
        return idx.astype(np.int32), w.astype(np.float32)
    if method == "nearest":
        src = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
        idx = np.clip(src.astype(np.int64), 0, in_size - 1)
        return idx.astype(np.int32)[:, None], np.ones((out_size, 1), np.float32)

    cubic = method == "bicubic"
    src = _source_coords(out_size, in_size, align_corners, scale, cubic)
    base = np.floor(src)
    t = src - base
    base = base.astype(np.int64)
    if cubic:
        w = _cubic_weights(t)
        idx = base[:, None] + np.arange(-1, 3)[None, :]
    else:  # bilinear
        w = np.stack([1.0 - t, t], axis=-1)
        idx = base[:, None] + np.arange(0, 2)[None, :]
    # torch clamps the tap index (replicate border), keeping the weight
    idx = np.clip(idx, 0, in_size - 1)
    return idx.astype(np.int32), w.astype(np.float32)


def _apply_axis(x: jnp.ndarray, axis: int, out_size: int, method: str,
                align_corners: bool, scale: Optional[float]) -> jnp.ndarray:
    in_size = x.shape[axis]
    idx, w = _plan_axis(out_size, in_size, method, align_corners, scale)
    taps = idx.shape[1]
    # identity shortcut: one tap of weight 1 mapping i -> i
    hot = np.argmax(w, axis=1)
    if (out_size == in_size
            and np.allclose(w[np.arange(out_size), hot], 1.0)
            and np.allclose(np.where(np.arange(taps)[None] == hot[:, None], 0, w), 0.0)
            and np.array_equal(idx[np.arange(out_size), hot], np.arange(in_size))):
        return x
    gathered = jnp.take(x, jnp.asarray(idx.reshape(-1)), axis=axis)
    new_shape = x.shape[:axis] + (out_size, taps) + x.shape[axis + 1:]
    gathered = gathered.reshape(new_shape)
    wshape = [1] * gathered.ndim
    wshape[axis], wshape[axis + 1] = out_size, taps
    w = jnp.asarray(w).reshape(wshape).astype(gathered.dtype)
    return (gathered * w).sum(axis=axis + 1)


def resize2d(x: jnp.ndarray, out_hw: Sequence[int], method: str = "bilinear",
             align_corners: bool = False,
             scale: Optional[Tuple[float, float]] = None) -> jnp.ndarray:
    """Resize the two spatial axes of an NHWC (or [..., H, W, C]) tensor.

    Args:
      x: [..., H, W, C].
      out_hw: target (H, W).
      method: "bilinear" | "bicubic" | "nearest" (torch conventions).
      align_corners: torch align_corners flag (ignored for nearest).
      scale: optional explicit (sh, sw) scale factors — reproduces torch's
        ``scale_factor=...`` coordinate mapping for half-pixel modes.
    """
    h_axis = x.ndim - 3
    w_axis = x.ndim - 2
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    sh, sw = (scale if scale is not None else (None, None))
    x = _apply_axis(x, h_axis, out_h, method, align_corners, sh)
    x = _apply_axis(x, w_axis, out_w, method, align_corners, sw)
    return x


def interpolate_like_torch(x: jnp.ndarray, size=None, scale_factor=None,
                           mode: str = "bilinear",
                           align_corners: bool = False) -> jnp.ndarray:
    """Convenience wrapper mirroring ``F.interpolate`` size computation."""
    h, w = x.shape[-3], x.shape[-2]
    if size is not None:
        return resize2d(x, size, mode, align_corners)
    sh, sw = (scale_factor if isinstance(scale_factor, (tuple, list))
              else (scale_factor, scale_factor))
    out_hw = (int(np.floor(h * sh)), int(np.floor(w * sw)))
    return resize2d(x, out_hw, mode, align_corners, scale=(sh, sw))
