"""Exact order statistics without sorting (radix select).

The k-th order statistic is found EXACTLY in 32 counting passes over the
bit-planes of the IEEE-754 representation (classic radix select):
total-ordered unsigned keys are built by flipping the sign bit of
non-negatives and all bits of negatives, then the k-th smallest key is
recovered most-significant-bit first, counting how many candidates fall in
the zero branch.  Each pass is a compare+reduce at memory bandwidth.  It
replaced a sort that was slow on another accelerator; whether it beats
``jnp.sort``/``top_k`` on the GPU is an open A/B (ROADMAP speed queue).

Gradients: the selected VALUE is bit-derived (no autodiff path) —
``kth_smallest`` is stop-gradiented by construction; callers that need a
differentiable statistic recover it with ``differentiable_value`` (mean
of the elements equal to the selected value, which spreads the cotangent
over exact ties; ``jnp.sort``-based selection gives it to one arbitrary
tie — a measure-zero difference).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["kth_smallest", "differentiable_value"]


def _sortable_bits(x: jnp.ndarray) -> jnp.ndarray:
    """fp32 -> uint32 such that uint order == total float order
    (-inf < ... < -0.0 < +0.0 < ... < +inf; NaNs sort above +inf)."""
    b = lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    return jnp.where((b >> 31) == 0,
                     b | jnp.uint32(0x80000000), ~b)


def _unsortable_bits(u: jnp.ndarray) -> jnp.ndarray:
    b = jnp.where((u >> 31) == 1, u & jnp.uint32(0x7FFFFFFF), ~u)
    return lax.bitcast_convert_type(b, jnp.float32)


def kth_smallest(x: jnp.ndarray, k) -> jnp.ndarray:
    """Exact k-th smallest (1-indexed) along the LAST axis.

    ``k`` may be a traced int32 (scalar or broadcastable to the batch
    shape); out-of-range k clamps to [1, n].  Returns the value with the
    batch shape, with gradients stopped (see module docstring)."""
    n = x.shape[-1]
    u = _sortable_bits(jax.lax.stop_gradient(x))
    k = jnp.clip(jnp.broadcast_to(jnp.asarray(k, jnp.int32), x.shape[:-1]),
                 1, n)
    prefix = jnp.zeros(x.shape[:-1], jnp.uint32)
    for bit in range(31, -1, -1):
        high_mask = jnp.uint32(
            (0xFFFFFFFF << (bit + 1)) & 0xFFFFFFFF if bit < 31 else 0)
        bitval = jnp.uint32(np.uint32(1) << bit)
        match = (u & high_mask) == prefix[..., None]
        zero_bit = (u & bitval) == 0
        c0 = jnp.sum(match & zero_bit, axis=-1).astype(jnp.int32)
        take_one = k > c0
        prefix = jnp.where(take_one, prefix | bitval, prefix)
        k = jnp.where(take_one, k - c0, k)
    return _unsortable_bits(prefix)


def differentiable_value(x: jnp.ndarray, value: jnp.ndarray) -> jnp.ndarray:
    """Recover ``value`` (a statistic of x along the last axis, e.g. from
    ``kth_smallest``) as a differentiable expression: the mean of the
    elements exactly equal to it."""
    eq = x == value[..., None]
    n_eq = jnp.maximum(jnp.sum(eq, axis=-1), 1)
    return jnp.sum(jnp.where(eq, x, 0.0), axis=-1) / n_eq
