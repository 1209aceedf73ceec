"""Multi-head attention over [B, T, H, D] tensors.

One entry point, ``dot_product_attention``, and one place that picks its
implementation, ``choose_implementation``:

- ``"cudnn"``: cuDNN's fused attention through
  ``jax.nn.dot_product_attention``.  The [B, H, Tq, Tk] logits never reach
  device memory (the memory-efficient attention the reference ran in its
  ViT and temporal blocks).
- ``"xla"``: einsum, float32 softmax, einsum, left to XLA.

Both keep the logits and the softmax in float32 (the reference's
``upcast_softmax``, motion_module/attention.py:198-204).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["dot_product_attention", "choose_implementation"]

# Measured on an H100 (chip_smoke.py phase 1 times both implementations
# at every call site; PERF.md): at 32 keys, the temporal attention, XLA's
# forward+backward is faster; at 1370 and more keys, the ViT, cuDNN is
# about 5x faster.
CUDNN_MIN_KEYS = 256


def choose_implementation(platform: str, dtype, head_dim: int, tq: int,
                          tk: int, masked: bool = False) -> str:
    """``"cudnn"`` or ``"xla"`` for one attention call.

    cuDNN's fused kernel takes fp16/bf16 with a head dim that is a multiple
    of 8 and at most 256 on Hopper, and its masked backward needs even
    sequence lengths."""
    if platform != "gpu" or jnp.dtype(dtype) not in (jnp.bfloat16,
                                                     jnp.float16):
        return "xla"
    if head_dim % 8 or head_dim > 256:
        return "xla"
    if masked and (tq % 2 or tk % 2):
        return "xla"
    return "cudnn" if tk >= CUDNN_MIN_KEYS else "xla"


def dot_product_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                          scale: Optional[float] = None,
                          mask: Optional[jnp.ndarray] = None,
                          implementation: Optional[str] = None
                          ) -> jnp.ndarray:
    """Attention of q [B, Tq, H, D] over k/v [B, Tk, H, D].

    Args:
      scale: logit scale; defaults to 1/sqrt(D) like the reference.
      mask: optional boolean [B|1, H|1, Tq|1, Tk]; False drops a key.
      implementation: ``"cudnn"`` or ``"xla"``; by default
        ``choose_implementation`` decides from the platform and shapes.
    """
    tq, tk = q.shape[1], k.shape[1]
    if implementation is None:
        implementation = choose_implementation(
            jax.default_backend(), q.dtype, q.shape[-1], tq, tk,
            mask is not None)
    if mask is not None and implementation == "cudnn":
        # cuDNN takes the mask as a full-length [.., Tq, Tk] bias
        mask = jnp.broadcast_to(mask, mask.shape[:2] + (tq, tk))
    return jax.nn.dot_product_attention(q, k, v, mask=mask, scale=scale,
                                        implementation=implementation)
