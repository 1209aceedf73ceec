"""Rotary position embeddings, real-valued (no complex dtypes).

Two variants used by the reference, both reimplemented with sin/cos pairs
instead of complex tensors:

- 1-D temporal RoPE over the frame axis of temporal attention
  (reference video_depth_anything/motion_module/attention.py:403-429):
  frequencies over the *full* inner dim, applied before head split.
- 2-D axial RoPE over the spatial token grid for SAM2-style memory attention
  (reference sam2/modeling/position_encoding.py:185-239): per-head-dim
  frequencies, first half of the pairs rotate by x, second half by y;
  ``repeat_k`` tiles the pattern across concatenated memory entries.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np

__all__ = ["temporal_rope_freqs", "apply_rope", "axial_rope_freqs"]


@lru_cache(maxsize=64)
def temporal_rope_freqs(dim: int, end: int, theta: float = 10000.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape [end, dim//2] (pairs interleaved)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    t = np.arange(end, dtype=np.float64)
    angles = np.outer(t, freqs)
    return (np.cos(angles).astype(np.float32),
            np.sin(angles).astype(np.float32))


@lru_cache(maxsize=64)
def axial_rope_freqs(head_dim: int, end_x: int, end_y: int,
                     theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of shape [end_x*end_y, head_dim//2] for a row-major
    (y, x) token grid: first head_dim//4 pairs rotate by x, rest by y."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 4)[:quarter] / head_dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    t_x, t_y = t % end_x, np.floor(t / end_x)
    ang_x = np.outer(t_x, freqs)
    ang_y = np.outer(t_y, freqs)
    angles = np.concatenate([ang_x, ang_y], axis=-1)
    return (np.cos(angles).astype(np.float32),
            np.sin(angles).astype(np.float32))


def apply_rope(x: jnp.ndarray, cos: jnp.ndarray, sin: jnp.ndarray,
               repeat_k: int = 1) -> jnp.ndarray:
    """Rotate interleaved (even, odd) pairs of the last axis of x.

    Args:
      x: [..., T, D] with D even; pairs are (x[..., 2i], x[..., 2i+1]).
      cos/sin: [T0, D//2] tables; T must equal T0 * repeat_k (the
        ``rope_k_repeat`` tiling for cross-attention to stacked memories).
    """
    orig_dtype = x.dtype
    t, d = x.shape[-2], x.shape[-1]
    cos = jnp.asarray(cos)
    sin = jnp.asarray(sin)
    if repeat_k > 1:
        cos = jnp.tile(cos, (repeat_k, 1))
        sin = jnp.tile(sin, (repeat_k, 1))
    assert cos.shape[0] == t, (cos.shape, x.shape)
    xf = x.astype(jnp.float32).reshape(*x.shape[:-1], d // 2, 2)
    even, odd = xf[..., 0], xf[..., 1]
    shape = (1,) * (x.ndim - 2) + (t, d // 2)
    cos = cos.reshape(shape)
    sin = sin.reshape(shape)
    out_even = even * cos - odd * sin
    out_odd = even * sin + odd * cos
    out = jnp.stack([out_even, out_odd], axis=-1).reshape(x.shape)
    return out.astype(orig_dtype)
