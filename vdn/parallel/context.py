"""Context (sequence) parallelism: ring attention over the frame axis.

The reference has no sequence scaling beyond a fixed 32-frame window
(SURVEY §2.9/§5) — its temporal attention is `(b·h·w, f, c)` on one GPU.
The frame axis shards across devices over NVLink: every stage of the video
model is frame-independent *except* temporal attention, so the whole forward
runs
under shard_map with the clip sharded P(data, seq), and the temporal
attention becomes a ring: each step computes a blockwise
(flash-style running-softmax) attention against the local K/V shard, then
rotates K/V to the next device with ppermute.  Peak memory per chip stays
O(T/p) and the permute overlaps with the matmuls.

``sequence_position_offset`` gives each shard its global frame offset so
absolute positional encodings stay correct.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vdn.parallel.mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["ring_attention", "sequence_position_offset",
           "make_context_parallel_forward", "distributed_kv_attention"]


def sequence_position_offset(axis_name: str, t_local: int) -> jnp.ndarray:
    """Global frame index of this shard's first frame."""
    return jax.lax.axis_index(axis_name) * t_local


def ring_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                   axis_name: str, scale: Optional[float] = None
                   ) -> jnp.ndarray:
    """Attention over [B, Tq_local, H, D] with K/V sharded over axis_name.

    Online-softmax combine across ring steps; math matches full attention
    over the gathered T axis exactly (fp32 softmax statistics)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = jax.lax.axis_size(axis_name)
    b, tq, h, d = q.shape

    qf = q.astype(jnp.float32)

    def step(carry, _):
        o, m, l, k_cur, v_cur = carry
        s = jnp.einsum("bqhd,bkhd->bhqk", qf, k_cur.astype(jnp.float32))
        s = s * scale
        m_cur = jnp.max(s, axis=-1, keepdims=True)
        m_new = jnp.maximum(m, m_cur)
        pmat = jnp.exp(s - m_new)
        corr = jnp.exp(m - m_new)  # [B, H, Tq, 1]
        l_new = l * corr + jnp.sum(pmat, axis=-1, keepdims=True)
        o = o * corr + jnp.einsum(
            "bhqk,bkhd->bhqd", pmat, v_cur.astype(jnp.float32))
        perm = [(i, (i + 1) % p) for i in range(p)]
        k_next = jax.lax.ppermute(k_cur, axis_name, perm)
        v_next = jax.lax.ppermute(v_cur, axis_name, perm)
        return (o, m_new, l_new, k_next, v_next), None

    # derive the initial carry from q so it inherits q's varying-manual-axes
    # type under shard_map (fresh constants would be "unvarying" and trip
    # the scan carry type check)
    o0 = jnp.swapaxes(qf, 1, 2) * 0.0               # [B, H, Tq, D]
    l0 = o0[..., :1]
    m0 = l0 - 1e30                                   # effective -inf
    (o, m, l, _, _), _ = jax.lax.scan(step, (o0, m0, l0, k, v),
                                      None, length=p)
    out = (o / l).astype(q.dtype)
    return out.transpose(0, 2, 1, 3)  # [B, Tq, H, D]


def distributed_kv_attention(q: jnp.ndarray, k: jnp.ndarray,
                             v: jnp.ndarray, axis_name: str,
                             bias: Optional[jnp.ndarray] = None,
                             scale: Optional[float] = None) -> jnp.ndarray:
    """Attention with REPLICATED queries over K/V sharded on axis_name.

    The context-parallel *streaming decode* primitive (the clip path uses
    ring_attention): each device scores its local K/V shard, then the
    softmax statistics combine exactly across the axis with one
    pmax + two psums — no ring needed because Tq is tiny (1-8 new
    frames per step).

    q: [B, Tq, H, D] (identical on every device of the axis);
    k/v: [B, Tc_local, H, D] local shards; bias: [Tc_local] logit bias
    (use a large negative to mask padded or cross-device-duplicate
    columns).  Math matches full attention over the concatenated column
    axis exactly (fp32 softmax statistics).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32),
                   k.astype(jnp.float32)) * scale
    if bias is not None:
        s = s + bias[None, None, None, :]
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    o = jnp.einsum("bhqk,bkhd->bhqd", p,
                   v.astype(jnp.float32))
    m_g = jax.lax.pmax(m, axis_name)
    corr = jnp.exp(m - m_g)
    l_g = jax.lax.psum(l * corr, axis_name)
    o_g = jax.lax.psum(o * corr, axis_name) / l_g
    return o_g.astype(q.dtype).transpose(0, 2, 1, 3)  # [B, Tq, H, D]


def make_context_parallel_forward(model, mesh: Mesh):
    """Jit the clip forward with the frame axis sharded over SEQ_AXIS.

    ``model`` must be constructed with ``seq_axis=SEQ_AXIS`` so its
    temporal attention uses the ring path.  Returns fn(params, x) for
    x [B, T, H, W, 3] (B divisible by mesh data dim, T by seq dim)."""
    from jax import shard_map

    def local_forward(params, x_local):
        return model.apply(params, x_local)

    sharded = shard_map(
        local_forward, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, SEQ_AXIS)),
        out_specs=P(DATA_AXIS, SEQ_AXIS),
        )

    @jax.jit
    def fwd(params, x):
        x = jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS)))
        return sharded(params, x)

    return fwd


def ulysses_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                      axis_name: str,
                      scale: Optional[float] = None) -> jnp.ndarray:
    """Ulysses-style context parallelism: all-to-all swaps the sharded
    frame axis for a sharded token axis, attention runs locally over the
    full frame range, then the swap reverses.  Numerically identical to
    full attention; communication is 2 all-to-alls instead of (p-1)
    ppermutes — a natural fit here because every other stage of the video
    model is frame-parallel (SURVEY §2.9 'Ulysses alternative').

    q/k/v: [B_local_tokens, T_local, H, D]; token axis must divide the
    axis size."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    from vdn.ops.attention import dot_product_attention

    def swap_in(x):   # [N, T/p, H, D] -> [N/p, T, H, D]
        return jax.lax.all_to_all(x, axis_name, 0, 1, tiled=True)

    q, k, v = swap_in(q), swap_in(k), swap_in(v)
    out = dot_product_attention(q, k, v, scale)
    return jax.lax.all_to_all(out, axis_name, 1, 0, tiled=True)


_CP_MODE = "ring"


def set_cp_mode(mode: str):
    """Selects the context-parallel attention: ``"ring"`` (ppermute ring,
    the default) or ``"alltoall"`` (Ulysses)."""
    assert mode in ("ring", "alltoall")
    globals()["_CP_MODE"] = mode


def cp_attention(q, k, v, axis_name: str,
                 scale: Optional[float] = None) -> jnp.ndarray:
    """Dispatch to the configured context-parallel attention flavor."""
    if _CP_MODE == "alltoall":
        return ulysses_attention(q, k, v, axis_name, scale)
    return ring_attention(q, k, v, axis_name, scale)
