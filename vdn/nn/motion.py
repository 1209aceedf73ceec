"""Temporal motion modules (AnimateDiff-style).

Re-design of the reference temporal attention stack
(reference video_depth_anything/motion_module/motion_module.py:32-326 and
attention.py:30-429): per-spatial-token self-attention across the frame axis,
inserted at four points of the temporal DPT head.

Differences from the reference by design:
- tensors are NHWC / [B, T, H, W, C]; the frame axis is reshaped against the
  spatial axes with plain reshapes+transposes (XLA fuses these)
- the KV cache is a pytree of fixed-shape arrays, not a python list of
  tensors, so streaming decode jits with static shapes
- softmax always fp32 (the reference runs fp16 under autocast)

Cache contract (matches reference list order dpt_temporal.py:74-96):
each TemporalModule produces ``num_transformer_block * num_attention_blocks``
cache entries and consumes the same number from the previous window.

Entry format: POSITION-FREE PACKED K/V, shape [heads * B*H*W, T, 2 * dh]
with lanes [K(dh) ‖ V(dh)], head-major rows.  The reference caches the
attention-block *inputs* and re-projects the whole ring through to_k/to_v
every step — but ring entries are immutable and the projections are
linear, so K/V are cacheable, and the window APE separates by linearity
exactly like the chunk-window algebra: K(entry at window pos p) =
K_cached + to_k(pe[p]).  That deletes the per-step ring re-projections
(2*N*CAP*C^2 FLOPs per attention block per chunk).
"""

from __future__ import annotations

import functools
import math
from typing import Any, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from vdn.nn import module as nn
from vdn.nn.layers import GroupNorm, LayerNorm, Linear
from vdn.ops.attention import dot_product_attention
from vdn.ops.rope import apply_rope, temporal_rope_freqs

Dtype = Any


def sinusoidal_positional_encoding(d_model: int, max_len: int) -> np.ndarray:
    """APE table (reference motion_module.py:195-213): [max_len, d_model]."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def ring_lane_width(dh: int) -> int:
    """Packed K/V ring lane width: 2*dh, padded up to 128 with zeros.
    The pad is a memory-layout choice whose worth on the GPU is an open
    A/B (ROADMAP speed queue)."""
    return max(2 * dh, 128)


def _pack_ring_entry(k, v, dpad: int):
    """k/v [h, n, t, dh] head-major -> [h*n, t, dpad] packed ring entry
    (lanes = [K(dh) | V(dh) | zero pad]).  The (h, n) merge is a free
    leading-dims reshape; t is the chunk length."""
    h, n, t, dh = k.shape
    parts = [k, v]
    if dpad > 2 * dh:
        parts.append(jnp.zeros(k.shape[:-1] + (dpad - 2 * dh,), k.dtype))
    return jnp.concatenate(parts, axis=-1).reshape(h * n, t, dpad)


class GEGLU(nn.Module):
    dim_out: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        y = Linear(self.dim_out * 2, param_dtype=self.param_dtype,
                   name="proj")(x)
        hidden, gate = jnp.split(y, 2, axis=-1)
        return hidden * jax.nn.gelu(gate, approximate=False)


class FeedForward(nn.Module):
    """GEGLU feed-forward (reference attention.py FeedForward, mult=4).
    Submodule names net_0/net_2 mirror the torch Sequential indices."""
    dim: int
    mult: int = 4
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        y = GEGLU(self.dim * self.mult, self.param_dtype, name="net_0")(x)
        return Linear(self.dim, param_dtype=self.param_dtype,
                      name="net_2")(y)


class TemporalAttention(nn.Module):
    """Self-attention across frames, one spatial token at a time.

    Input [(B*N), T, C] (token-major — TemporalTransformer3D relayouts
    once at module entry so no attention block pays a [(B*T), N, C]
    transpose; the round-3 trace showed those per-block relayouts fusing
    into the projection dots at up to 26x over peak); attends over T per
    token.  With a cache [heads*B*N, T_cache, 2*dh] (position-free
    packed K/V — see the module docstring), only the T_new current
    frames are queried while keys/values span cache + new (reference
    attention.py:245-326).
    Returns (output [(B*N), T_new, C], cache_entry
    [heads*B*N, T_new, 2*dh]).

    Context-parallel streaming (cache + seq_axis): the cache argument is
    each device's LOCAL shard of the KV window (sharded along T_cache);
    the new frames are replicated.  ``cache_len`` gives the number of
    logically valid entries across the whole axis (trailing shards may
    be zero-padding so the window length divides the axis size); the
    softmax combines exactly across devices via
    vdn.parallel.context.distributed_kv_attention.
    """
    query_dim: int
    heads: int = 8
    temporal_max_len: int = 32
    pos_embedding_type: str = "ape"
    param_dtype: Dtype = jnp.float32
    seq_axis: Optional[str] = None  # mesh axis for ring attention

    @nn.compact
    def __call__(self, hidden_states: jnp.ndarray, video_length: int,
                 cache: Optional[jnp.ndarray] = None,
                 cache_len: Optional[int] = None):
        if isinstance(cache, tuple):
            # batched chunk-window mode: cache = (ring buffer, window
            # one-hot); all frames of the chunk decode in ONE batched
            # attention (no per-frame scan) — see _chunk_window.  With
            # seq_axis set, the ring buffer is this device's shard of the
            # CAP axis and the window logits/outputs combine with psums.
            assert self.pos_embedding_type == "ape"
            return self._chunk_window(hidden_states, *cache)

        x = hidden_states                    # [(b n), t_new, c]
        bn, t_new, c = x.shape

        if cache is not None and self.seq_axis is not None:
            return self._cached_cp(x, cache, cache_len, c)
        if cache is not None and self.pos_embedding_type == "ape":
            return self._cached_local(x, cache, c)

        d_in = 0
        if cache is not None:
            d_in = cache.shape[1]
            x = jnp.concatenate([cache.astype(x.dtype), x], axis=1)
        t_total = d_in + t_new

        # global frame offset of this shard (0 when not sequence-parallel)
        if self.seq_axis is not None:
            from vdn.parallel.context import sequence_position_offset
            offset = sequence_position_offset(self.seq_axis, t_new)
        else:
            offset = 0

        if self.pos_embedding_type == "ape":
            pe = jnp.asarray(sinusoidal_positional_encoding(
                self.query_dim, self.temporal_max_len))
            pe_slice = jax.lax.dynamic_slice(
                pe, (offset, 0), (t_total, pe.shape[1])) \
                if self.seq_axis is not None else pe[:t_total]
            x = x + pe_slice[None].astype(x.dtype)
        elif self.pos_embedding_type != "rope":
            raise NotImplementedError(self.pos_embedding_type)

        q_in = x[:, d_in:]
        to_k_m = Linear(c, use_bias=False, param_dtype=self.param_dtype,
                        name="to_k")
        to_v_m = Linear(c, use_bias=False, param_dtype=self.param_dtype,
                        name="to_v")
        query = Linear(c, use_bias=False, param_dtype=self.param_dtype,
                       name="to_q")(q_in)
        key = to_k_m(x)
        value = to_v_m(x)

        if self.pos_embedding_type == "rope":
            # reference applies rope on the full inner dim before head split
            # (attention.py:279-282); cache mode is unsupported there too
            assert cache is None, "rope temporal attention has no cache mode"
            cos, sin = temporal_rope_freqs(self.query_dim,
                                           self.temporal_max_len)
            if self.seq_axis is not None:
                cos_l = jax.lax.dynamic_slice(
                    jnp.asarray(cos), (offset, 0), (t_new, cos.shape[1]))
                sin_l = jax.lax.dynamic_slice(
                    jnp.asarray(sin), (offset, 0), (t_new, sin.shape[1]))
                query = apply_rope(query, cos_l, sin_l)
                key = apply_rope(key, cos_l, sin_l)
            else:
                query = apply_rope(query, cos[:t_new], sin[:t_new])
                key = apply_rope(key, cos[:t_total], sin[:t_total])

        h = self.heads
        dh = c // h
        if self.seq_axis is not None:
            from vdn.parallel.context import cp_attention
            out = cp_attention(
                query.reshape(bn, t_new, h, dh),
                key.reshape(bn, t_total, h, dh),
                value.reshape(bn, t_total, h, dh),
                axis_name=self.seq_axis)
        else:
            out = dot_product_attention(
                query.reshape(bn, t_new, h, dh),
                key.reshape(bn, t_total, h, dh),
                value.reshape(bn, t_total, h, dh))
        out = out.reshape(bn, t_new, c)
        out = Linear(self.query_dim, param_dtype=self.param_dtype,
                     name="to_out_0")(out)
        # position-free packed K/V ring entry from the RAW (pre-PE)
        # inputs — DCE'd whenever the caller drops the caches.  (The
        # rope path never serves a cache mode; entries are still emitted
        # for shape consistency but position-free K is not rotatable, so
        # rope callers must not consume them — guarded by the cache-mode
        # assert above.)
        k_e = to_k_m(hidden_states).reshape(
            bn, t_new, h, dh).transpose(2, 0, 1, 3)
        v_e = to_v_m(hidden_states).reshape(
            bn, t_new, h, dh).transpose(2, 0, 1, 3)
        entry = _pack_ring_entry(k_e, v_e, ring_lane_width(dh))
        return out, entry

    def _weights_hview(self, x, c):
        """(wq_h, wk_h, wv_h, wo, bo): q/k/v weights viewed [h, C, dh]
        (projections emit head-major directly) + raw out-proj params."""
        dt = x.dtype
        h = self.heads
        wq, _ = Linear(c, use_bias=False, param_dtype=self.param_dtype,
                       name="to_q")(x, params_only=True)
        wk, _ = Linear(c, use_bias=False, param_dtype=self.param_dtype,
                       name="to_k")(x, params_only=True)
        wv, _ = Linear(c, use_bias=False, param_dtype=self.param_dtype,
                       name="to_v")(x, params_only=True)
        wo, bo = Linear(self.query_dim, param_dtype=self.param_dtype,
                        name="to_out_0")(x, params_only=True)
        hview = lambda wgt: wgt.astype(dt).reshape(
            c, h, c // h).transpose(1, 0, 2)
        return hview(wq), hview(wk), hview(wv), wo, bo

    def _cached_local(self, x_new, cache, c):
        """Cached decode over a position-free packed K/V window.

        cache [h*B*N, d_in, 2*dh]: the gathered ring window — K/V were
        projected ONCE when each entry was written; the window APE
        attaches by linearity (K at window pos p = K_cached + to_k(pe[p]),
        same algebra as _chunk_window).  No concat([cache, new]) is ever
        materialized and no ring re-projection runs (2*N*31*C^2 FLOPs per
        block)."""
        bn, t_new = x_new.shape[0], x_new.shape[1]
        h, dh = self.heads, c // self.heads
        d_in = cache.shape[1]
        t_total = d_in + t_new
        dt = x_new.dtype
        pe = jnp.asarray(sinusoidal_positional_encoding(
            self.query_dim, self.temporal_max_len)).astype(dt)

        wq_h, wk_h, wv_h, wo, bo = self._weights_hview(x_new, c)
        proj = functools.partial(jnp.einsum, "ntc,hcd->hntd")
        pe_k = jnp.einsum("pc,hcd->hpd", pe[:t_total], wk_h)  # [h,T,dh]
        pe_v = jnp.einsum("pc,hcd->hpd", pe[:t_total], wv_h)

        q = proj(x_new + pe[d_in:t_total][None], wq_h)   # [h,bn,t_new,dh]
        k_e = proj(x_new, wk_h)                          # position-free
        v_e = proj(x_new, wv_h)
        k_n = k_e + pe_k[:, None, d_in:]
        v_n = v_e + pe_v[:, None, d_in:]
        dpad = cache.shape[-1]                           # ring lane width
        kv = cache.reshape(h, bn, d_in, dpad).astype(dt)

        scale = dh ** -0.5
        logit = functools.partial(jnp.einsum, "hntd,hnkd->hntk",
                                  preferred_element_type=jnp.float32)
        # packed-dot form: zero-padded q contracts the packed window
        # directly (no K/V lane split — see _chunk_window); the
        # cache-side APE attaches on the LOGITS (q . to_k(pe[p])) and on
        # the OUTPUT (probs . to_v(pe[p])) by linearity
        qz = jnp.concatenate(
            [q, jnp.zeros(q.shape[:-1] + (dpad - dh,), dt)], axis=-1)
        qpe_c = jnp.einsum("hntd,hpd->hntp", q, pe_k[:, :d_in],
                           preferred_element_type=jnp.float32)
        logits = jnp.concatenate(
            [logit(qz, kv) + qpe_c, logit(q, k_n)], axis=-1) * scale
        probs = jax.nn.softmax(logits, axis=-1).astype(dt)
        out = jnp.einsum("hntk,hnkd->hntd", probs[..., :d_in],
                         kv)[..., dh:2 * dh] \
            + jnp.einsum("hntk,hkd->hntd", probs[..., :d_in],
                         pe_v[:, :d_in]) \
            + jnp.einsum("hntk,hnkd->hntd", probs[..., d_in:], v_n)

        wo_h = wo.astype(dt).reshape(h, dh, self.query_dim)
        out = jnp.einsum("hntd,hdc->ntc", out, wo_h) + bo.astype(dt)
        entry = _pack_ring_entry(k_e, v_e, ring_lane_width(dh))
        return out, entry

    def _chunk_window(self, x, buf, onehot):
        """Batched streaming decode: k frames in ONE window attention.

        No frame in a chunk depends on another frame's output at the SAME
        attention block (cache entries are block *inputs*, reference
        motion_module.py:326), so the per-frame scan is unnecessary: every
        frame queries its own 31-entry window assembled from (ring buffer,
        in-chunk entries) via a host-built one-hot column map.

        x: [N, k, C] — this block's (LayerNorm'd) inputs for all k frames;
        buf: [h*N, CAP, 2*dh] ring buffer of position-free packed K/V
        entries (see the module docstring);
        onehot: [k, W, CAP+k] fp — onehot[j, p] selects the column (ring
        slot or CAP+i for in-chunk frame i) at window position p of frame
        j's window; position W-1 is the frame's own entry.

        The window APE is applied via linearity: K(col at pos p) =
        to_k(raw + pe[p]) = to_k(raw) + to_k(pe[p]), so ring/chunk columns
        are projected ONCE (position-free) and the q.to_k(pe) /
        probs.to_v(pe) corrections are added per window position — exact
        up to fp reassociation (covered by the chunked-vs-per-frame
        parity test).  Queries always sit at window position W-1 (the
        stream pipeline's windows are always full; the first frame goes
        through the full-window path instead).

        Context parallel (``seq_axis`` set): ``buf`` is this device's
        shard of the ring's CAP axis ([h*N, CAP/p, 2*dh]; onehot's ring
        columns span the GLOBAL capacity) and x/onehot are replicated.
        The one-hot gather distributes over the column shards — every
        (frame, window-position) pair has exactly one owning column, so
        the local partial window-logit map is exact where owned and 0.0
        elsewhere, and one ``psum`` rebuilds the full [k, W] logit map on
        every device (W=32 is tiny).  The value matmul psums the same
        way.  In-chunk columns (and the APE corrections) are owned by
        the LAST device of the axis, mirroring ``_cached_cp``.

        Returns (out [N, k, C], cache_entry [h*N, k, 2*dh] — ring
        layout).
        """
        n, kf, c = x.shape
        cap = buf.shape[1]   # LOCAL ring columns (== global when no CP)
        w = self.temporal_max_len
        h, dh = self.heads, c // self.heads

        pe = jnp.asarray(sinusoidal_positional_encoding(
            self.query_dim, w)).astype(x.dtype)
        # HEAD-MAJOR algebra: projections emit [h, n, *, dh] directly
        # via weights reshaped [h, C, dh], and the out-projection
        # contracts (h, dh) back to [n, k, C] in one dot, so no head
        # split or merge is materialized.  The ring holds position-free
        # packed K/V [h*n, cap, 2*dh], so only the k new frames project.
        dt = x.dtype
        wq_h, wk_h, wv_h, wo, bo = self._weights_hview(x, c)
        proj = functools.partial(jnp.einsum, "njc,hcd->hnjd")

        qh = proj(x + pe[w - 1], wq_h)                   # [h, n, kf, dh]
        # ring and in-chunk columns stay SEPARATE operands: a
        # [h, n, cap+k, dh] concat would copy both K and V; concatenating
        # in the tiny fp32 logits space (and slicing probs) is cheaper
        k_n, v_n = proj(x, wk_h), proj(x, wv_h)          # position-free
        # The ring is consumed in its stored 3-D shape with the flat
        # r = h*n batch axis, without splitting the K/V halves: the
        # zero-padded q contracts the full packed width and the AV
        # output slices [dh:2dh] (j-sized, ~5x smaller than the ring).
        r = h * n
        dpad = ring_lane_width(dh)
        kv3 = buf.astype(dt)                             # [r, cap, dpad]
        entry = _pack_ring_entry(k_n, v_n, dpad)         # [r, kf, dpad]
        flat = lambda a: a.reshape((r,) + a.shape[2:])   # [h,n,..] view
        unflat = lambda a: a.reshape((h, n) + a.shape[1:])
        qz = flat(jnp.concatenate(
            [qh, jnp.zeros(qh.shape[:-1] + (dpad - dh,), dt)], axis=-1))
        pe_k = jnp.einsum("pc,hcd->hpd", pe, wk_h)       # [h, w, dh]
        pe_v = jnp.einsum("pc,hcd->hpd", pe, wv_h)

        axis = self.seq_axis
        if axis is not None:
            p = jax.lax.axis_size(axis)
            cap_g = onehot.shape[2] - kf
            assert cap_g == cap * p, (
                "CP chunk-window: global ring capacity must be p * local "
                f"shard ({cap_g} != {p} * {cap})")
            my = jax.lax.axis_index(axis)
            # this device's slice of the column map: its ring shard plus
            # (last device only) the in-chunk columns
            oh_ring = jax.lax.dynamic_slice(
                onehot, (0, 0, my * cap), (kf, w, cap))
            own_chunk = (my == p - 1).astype(onehot.dtype)
            onehot = jnp.concatenate(
                [oh_ring, onehot[:, :, cap_g:] * own_chunk], axis=-1)

        lg_ring = jnp.einsum("rjd,rcd->rjc", qz, kv3,
                             preferred_element_type=jnp.float32)
        lg_new = jnp.einsum("hnjd,hncd->hnjc", qh, k_n,
                            preferred_element_type=jnp.float32)
        logits_cols = jnp.concatenate([lg_ring, flat(lg_new)], axis=-1)
        qpe = jnp.einsum("hnjd,hpd->hnjp", qh, pe_k,
                         preferred_element_type=jnp.float32)
        # gather each frame's 32 window logits out of the CAP+k columns
        logits_win = jnp.einsum("rjc,jpc->rjp", logits_cols,
                                onehot.astype(jnp.float32))
        if axis is not None:
            # exactly one device owns each (frame, position) column;
            # everyone else contributed exact 0.0 terms
            logits_win = jax.lax.psum(logits_win, axis)
        logits_win = logits_win + flat(qpe)
        probs = jax.nn.softmax(logits_win * (dh ** -0.5), axis=-1)
        pd = probs.astype(dt)
        # scatter probs back to columns for the shared-column value matmul
        p_cols = jnp.einsum("rjp,jpc->rjc", pd, onehot.astype(dt))
        out = unflat(jnp.einsum(
            "rjc,rcd->rjd", p_cols[..., :cap], kv3)[..., dh:2 * dh]) \
            + jnp.einsum("hnjc,hncd->hnjd",
                         unflat(p_cols[..., cap:]), v_n)
        if axis is not None:
            out = jax.lax.psum(out, axis)
        out = out + jnp.einsum("hnjp,hpd->hnjd", unflat(pd), pe_v)
        # fused out-projection: contract (h, dh) -> C, no head-merge copy
        wo_h = wo.astype(dt).reshape(h, dh, self.query_dim)
        out = jnp.einsum("hnjd,hdc->njc", out, wo_h) + bo.astype(dt)
        return out, entry

    def _cached_cp(self, x_new, cache, cache_len, c):
        """Streaming decode with the KV window sharded over seq_axis.

        x_new [B*N, t_new, C] replicated; cache [h*B*N, d_local, 2*dh]
        local shard of the position-free packed K/V window (the APE
        attaches by linearity per GLOBAL position, so shard-local
        entries stay position-free at rest).  Columns beyond
        ``cache_len`` (zero padding so the window divides the axis) and
        the new-frame KV on every device but the last are masked out of
        the softmax, so the math equals the single-device path
        exactly."""
        assert self.pos_embedding_type == "ape", \
            "CP streaming decode supports APE (rope has no cache mode)"
        axis = self.seq_axis
        p = jax.lax.axis_size(axis)
        bn, t_new = x_new.shape[0], x_new.shape[1]
        h, dh = self.heads, c // self.heads
        d_local = cache.shape[1]
        cl = cache_len if cache_len is not None else p * d_local
        my = jax.lax.axis_index(axis)
        idx = my * d_local + jnp.arange(d_local)
        dt = x_new.dtype

        pe = jnp.asarray(sinusoidal_positional_encoding(
            self.query_dim, self.temporal_max_len)).astype(dt)
        new_pe = pe[cl:cl + t_new]

        wq_h, wk_h, wv_h, wo, bo = self._weights_hview(x_new, c)
        proj = functools.partial(jnp.einsum, "ntc,hcd->hntd")
        pe_k = jnp.einsum("pc,hcd->hpd", pe, wk_h)       # [h, W, dh]
        pe_v = jnp.einsum("pc,hcd->hpd", pe, wv_h)
        idx_cl = jnp.minimum(idx, self.temporal_max_len - 1)

        q = proj(x_new + new_pe[None], wq_h)             # [h,bn,t_new,dh]
        k_e = proj(x_new, wk_h)                          # position-free
        v_e = proj(x_new, wv_h)
        dpad = cache.shape[-1]                           # ring lane width
        kv = cache.reshape(h, bn, d_local, dpad).astype(dt)
        k_c = kv[..., :dh] + pe_k[:, None, idx_cl]
        v_c = kv[..., dh:2 * dh] + pe_v[:, None, idx_cl]
        k_n = k_e + pe_k[:, None, cl:cl + t_new]
        v_n = v_e + pe_v[:, None, cl:cl + t_new]

        neg = jnp.float32(-1e30)
        bias = jnp.concatenate([
            jnp.where(idx < cl, jnp.float32(0), neg),
            jnp.where(my == p - 1, jnp.float32(0), neg)
            * jnp.ones((t_new,), jnp.float32)])

        from vdn.parallel.context import distributed_kv_attention
        to_bthd = lambda a: a.transpose(1, 2, 0, 3)      # [bn, T, h, dh]
        out = distributed_kv_attention(
            to_bthd(q),
            to_bthd(jnp.concatenate([k_c, k_n], axis=2)),
            to_bthd(jnp.concatenate([v_c, v_n], axis=2)), axis, bias)
        out = out.reshape(bn, t_new, c)
        out = jnp.matmul(out, wo.astype(dt)) + bo.astype(dt)
        entry = _pack_ring_entry(k_e, v_e, ring_lane_width(dh))
        return out, entry


class TemporalTransformerBlock(nn.Module):
    dim: int
    heads: int = 8
    num_attention_blocks: int = 2
    temporal_max_len: int = 32
    pos_embedding_type: str = "ape"
    param_dtype: Dtype = jnp.float32
    seq_axis: Optional[str] = None

    @nn.compact
    def __call__(self, x, video_length: int,
                 caches: Optional[Sequence[jnp.ndarray]] = None,
                 cache_len: Optional[int] = None):
        out_caches = []
        for i in range(self.num_attention_blocks):
            y = LayerNorm(param_dtype=self.param_dtype, name=f"norms_{i}")(x)
            y, cache_entry = TemporalAttention(
                self.dim, self.heads, self.temporal_max_len,
                self.pos_embedding_type, self.param_dtype, self.seq_axis,
                name=f"attention_blocks_{i}")(
                    y, video_length,
                    caches[i] if caches is not None else None, cache_len)
            x = y + x
            out_caches.append(cache_entry)
        ff_norm = LayerNorm(param_dtype=self.param_dtype, name="ff_norm")
        ff = FeedForward(self.dim, param_dtype=self.param_dtype, name="ff")
        x = ff(ff_norm(x)) + x
        return x, out_caches


class TemporalTransformer3D(nn.Module):
    """GroupNorm + proj_in/out around the transformer blocks
    (reference TemporalTransformer3DModel, motion_module.py:68-136)."""
    in_channels: int
    heads: int = 8
    num_layers: int = 1
    num_attention_blocks: int = 2
    norm_num_groups: int = 32
    temporal_max_len: int = 32
    pos_embedding_type: str = "ape"
    param_dtype: Dtype = jnp.float32
    seq_axis: Optional[str] = None

    @nn.compact
    def __call__(self, x: jnp.ndarray, video_length: int,
                 caches: Optional[Sequence[jnp.ndarray]] = None,
                 cache_len: Optional[int] = None):
        # x: [(B*T_new), H, W, C]
        bt, hh, ww, c = x.shape
        t = video_length
        b, n = bt // t, hh * ww
        residual = x
        y = GroupNorm(self.norm_num_groups, epsilon=1e-6,
                      param_dtype=self.param_dtype, name="norm")(x)
        # relayout ONCE to token-major [(B*N), T, C]: every attention
        # block, LN, FF, and projection then runs transpose-free
        y = y.reshape(b, t, n, c).transpose(0, 2, 1, 3).reshape(b * n, t, c)
        y = Linear(c, param_dtype=self.param_dtype, name="proj_in")(y)

        out_caches: List[jnp.ndarray] = []
        n_per = self.num_attention_blocks
        for i in range(self.num_layers):
            y, blk_caches = TemporalTransformerBlock(
                c, self.heads, self.num_attention_blocks,
                self.temporal_max_len, self.pos_embedding_type,
                self.param_dtype, self.seq_axis,
                name=f"transformer_blocks_{i}")(
                    y, video_length,
                    caches[i * n_per:(i + 1) * n_per]
                    if caches is not None else None, cache_len)
            out_caches.extend(blk_caches)

        # zero-initialized so the temporal mixer starts as identity
        # (reference motion_module.py:57-58 zero_initialize)
        y = Linear(self.in_channels, param_dtype=self.param_dtype,
                   kernel_init=jax.nn.initializers.zeros, name="proj_out")(y)
        y = y.reshape(b, n, t, c).transpose(0, 2, 1, 3).reshape(
            bt, hh, ww, c)
        return y + residual, out_caches


class TemporalModule(nn.Module):
    """Zero-initialized residual temporal mixer (reference TemporalModule).

    Takes/returns [(B*T_new), H, W, C] feature maps plus the cache pytree.
    """
    in_channels: int
    num_attention_heads: int = 8
    num_transformer_block: int = 1
    num_attention_blocks: int = 2
    temporal_max_len: int = 32
    pos_embedding_type: str = "ape"
    param_dtype: Dtype = jnp.float32
    seq_axis: Optional[str] = None

    @nn.compact
    def __call__(self, x, video_length: int,
                 caches: Optional[Sequence[jnp.ndarray]] = None,
                 cache_len: Optional[int] = None):
        return TemporalTransformer3D(
            self.in_channels, self.num_attention_heads,
            self.num_transformer_block, self.num_attention_blocks,
            temporal_max_len=self.temporal_max_len,
            pos_embedding_type=self.pos_embedding_type,
            param_dtype=self.param_dtype, seq_axis=self.seq_axis,
            name="temporal_transformer")(x, video_length, caches,
                                         cache_len)
