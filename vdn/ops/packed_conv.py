"""Lane-packed small-N conv head: 3x3 conv to few channels + 1x1 collapse.

The DPT output island (reference dpt_temporal.py:108-110,
depth_anything_v2/dpt.py:140-151) ends in `conv3x3(C->32) -> ReLU ->
conv1x1(32->1) -> act` at full output resolution.  An N=32 conv fills a
quarter of a 128-wide output tile and materializes an fp32
[N, H, W, 32] intermediate.

This module packs P = 128//N_out horizontally adjacent output pixels
into one 128-wide channel group by widening the kernel to
[3, 3+P-1, C, 128] with P shifted copies and striding the conv by P,
and the 1x1 collapse becomes a tiny block-diagonal matmul
(kron(I_P, w2)) applied directly to the packed layout — no relayout
until the final [*, G, P] -> [*, W] ungroup of the 1-channel result.
The layout was chosen for a 128-wide matrix unit; whether it pays on
the GPU against the plain conv pair is an open A/B (ROADMAP speed
queue).

The packed conv computes the same sums as the unpacked one (the pad
columns contribute exact zeros); only fp32 accumulation order differs.
Precision: the 3x3 conv takes compute-dtype operands with an fp32
accumulator (bf16 in serving; fp32 compute runs at the default
precision, TF32 on the GPU); the fp32 collapse runs at HIGHEST.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from vdn.nn.layers import _conv_nhwc_accum


def packed_island_head(x, w1, b1, w2, b2,
                       final_act: Callable[[jnp.ndarray], jnp.ndarray],
                       accum_dtype=jnp.float32) -> jnp.ndarray:
    """relu(conv3x3(x, w1) + b1) @ w2 + b2 -> final_act, lane-packed.

    Args:
      x: [N, H, W, C] feature map (compute dtype).
      w1: [3, 3, C, O] conv kernel, O | 128.
      b1: [O] bias (or None).
      w2: [O, OO] pointwise collapse weights (OO typically 1).
      b2: [OO] bias (or None).
      final_act: activation applied to the collapsed output.
    Returns:
      [N, H, W, OO] in ``accum_dtype`` (the fp32 island output).
    """
    n, h, w, c = x.shape
    o = w1.shape[-1]
    oo = w2.shape[-1]
    p = 128 // o
    if p <= 1 or 128 % o != 0:
        raise ValueError(f"out channels {o} not packable")
    groups = -(-w // p)
    pad_r = p * groups - (w - 1)

    # [3, 3+P-1, C, P*O]: shifted copies; pad columns contribute zeros
    wp = jnp.concatenate(
        [jnp.pad(w1, ((0, 0), (s, p - 1 - s), (0, 0), (0, 0)))
         for s in range(p)], axis=-1)
    y = _conv_nhwc_accum(x, wp.astype(x.dtype), (1, p),
                         ((1, 1), (1, pad_r)), 1, accum_dtype)
    if b1 is not None:
        y = y + jnp.tile(b1, p).astype(y.dtype)
    y = jnp.maximum(y, 0.0)
    # block-diagonal collapse in the packed layout: [P*O, P*OO]
    w2b = jnp.kron(jnp.eye(p, dtype=accum_dtype), w2.astype(accum_dtype))
    z = jnp.einsum("nhgk,ko->nhgo", y, w2b,
                   precision=jax.lax.Precision.HIGHEST)
    if b2 is not None:
        z = z + jnp.tile(b2, p).astype(z.dtype)
    z = z.reshape(n, h, groups * p, oo)[:, :, :w, :]
    return final_act(z)
