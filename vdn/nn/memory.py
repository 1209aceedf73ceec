"""Cross-frame memory attention for the single-image depth model.

Re-design of the reference MemoryBlock
(reference depth_anything_v2/memory_block.py:12-125) and the SAM2 pieces it
grafts in (sam2/modeling/memory_attention.py:17-169, memory_encoder.py:17-181,
sam/transformer.py:189-311 RoPEAttention, position_encoding.py:16-239):

- the python deque memory bank (memory_bank.py:3-23, maxlen=6) becomes a
  fixed-capacity, right-aligned ring buffer [B, L, HW, C] + a count; invalid
  slots are masked out of the cross-attention with a boolean key mask, which
  is jit-static and matches the reference's variable-length concat exactly
- 2-D axial RoPE is real-valued (vdn.ops.rope.axial_rope_freqs)
- the memory encoder (sigmoid(depth) -> stride-2*7 mask pyramid -> ConvNeXt
  fuser -> sine pos enc) is NHWC

State flows functionally: ``forward(feature, state)`` reads,
``encode(feature, depth)`` + ``update_state`` write.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vdn.nn import module as nn
from vdn.nn.layers import Conv2d, LayerNorm, Linear
from vdn.ops.attention import dot_product_attention
from vdn.ops.rope import apply_rope, axial_rope_freqs
from vdn.ops.sine_pe import sine_position_embedding_2d

Dtype = Any


def init_memory_state(batch: int, num_tokens: int, channels: int,
                      capacity: int = 6, dtype=jnp.float32) -> Dict:
    """Empty ring-buffer state (newest entry lives in the last slot)."""
    shape = (batch, capacity, num_tokens, channels)
    return {
        "features": jnp.zeros(shape, dtype),
        "pos": jnp.zeros(shape, dtype),
        "count": jnp.zeros((), jnp.int32),
    }


def update_memory_state(state: Dict, feature: jnp.ndarray,
                        pos: jnp.ndarray) -> Dict:
    """Shift left, append newest at the last slot (deque semantics,
    reference memory_bank.py:10-14)."""
    cap = state["features"].shape[1]
    return {
        "features": jnp.concatenate(
            [state["features"][:, 1:], feature[:, None]], axis=1),
        "pos": jnp.concatenate(
            [state["pos"][:, 1:], pos[:, None]], axis=1),
        "count": jnp.minimum(state["count"] + 1, cap),
    }


class RoPEAttention(nn.Module):
    """SAM2 RoPE attention (reference sam2/modeling/sam/transformer.py:251-311).

    q/k/v/out projections with bias; axial 2-D rope over the token grid;
    ``rope_k_repeat`` tiles the rope pattern over stacked memory entries.
    """
    embedding_dim: int
    num_heads: int
    rope_k_repeat: bool = False
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, q, k, v, grid_hw: Tuple[int, int],
                 mask: Optional[jnp.ndarray] = None,
                 num_k_exclude_rope: int = 0):
        """num_k_exclude_rope: trailing kv tokens (SAM2 object pointers)
        that skip the rotary encoding (reference transformer.py:293-302)."""
        c = self.embedding_dim
        h = self.num_heads
        dh = c // h
        b, nq, _ = q.shape
        nk = k.shape[1]
        q = Linear(c, param_dtype=self.param_dtype, name="q_proj")(q)
        k = Linear(c, param_dtype=self.param_dtype, name="k_proj")(k)
        v = Linear(c, param_dtype=self.param_dtype, name="v_proj")(v)
        q = q.reshape(b, nq, h, dh)
        k = k.reshape(b, nk, h, dh)
        v = v.reshape(b, nk, h, dh)

        gh, gw = grid_hw
        assert gh * gw == nq
        cos, sin = axial_rope_freqs(dh, gw, gh)
        # rope tables index [T, dh/2]; heads axis broadcasts (move T to -2)
        q = q.transpose(0, 2, 1, 3)
        k = k.transpose(0, 2, 1, 3)
        q = apply_rope(q, cos, sin)
        num_k_rope = nk - num_k_exclude_rope
        repeat = num_k_rope // nq
        assert repeat * nq == num_k_rope and (
            repeat == 1 or self.rope_k_repeat)
        k_rope = apply_rope(k[:, :, :num_k_rope], cos, sin, repeat_k=repeat)
        k = jnp.concatenate([k_rope, k[:, :, num_k_rope:]], axis=2) \
            if num_k_exclude_rope else k_rope
        q = q.transpose(0, 2, 1, 3)
        k = k.transpose(0, 2, 1, 3)

        out = dot_product_attention(q, k, v, mask=mask)
        out = out.reshape(b, nq, c)
        return Linear(c, param_dtype=self.param_dtype, name="out_proj")(out)


class MemoryAttentionLayer(nn.Module):
    """Self-attn + RoPE cross-attn to memory + FFN (reference
    sam2/modeling/memory_attention.py:17-99; flag config from
    depth_anything_v2/memory_block.py:32-42: pos enc only on
    cross-attention queries)."""
    d_model: int
    num_heads: int
    dim_feedforward: int
    param_dtype: Dtype = jnp.float32
    activation: str = "gelu"                    # sam2 video config: "relu"
    pos_enc_at_cross_attn_queries: bool = True  # sam2 video config: False
    pos_enc_at_cross_attn_keys: bool = False

    @nn.compact
    def __call__(self, tgt, memory, query_pos, grid_hw,
                 mask: Optional[jnp.ndarray] = None,
                 memory_pos: Optional[jnp.ndarray] = None,
                 num_k_exclude_rope: int = 0):
        pd = self.param_dtype
        # self-attention (pos_enc_at_attn=False)
        t2 = LayerNorm(epsilon=1e-5, param_dtype=pd, name="norm1")(tgt)
        t2 = RoPEAttention(self.d_model, self.num_heads, False, pd,
                           name="self_attn")(t2, t2, t2, grid_hw)
        tgt = tgt + t2
        # cross-attention (pos-enc placement per flags)
        t2 = LayerNorm(epsilon=1e-5, param_dtype=pd, name="norm2")(tgt)
        q_in = (t2 + query_pos if self.pos_enc_at_cross_attn_queries
                else t2)
        k_in = memory
        if self.pos_enc_at_cross_attn_keys and memory_pos is not None:
            k_in = memory + memory_pos
        t2 = RoPEAttention(self.d_model, self.num_heads, True, pd,
                           name="cross_attn_image")(
                               q_in, k_in, memory, grid_hw, mask=mask,
                               num_k_exclude_rope=num_k_exclude_rope)
        tgt = tgt + t2
        # FFN
        t2 = LayerNorm(epsilon=1e-5, param_dtype=pd, name="norm3")(tgt)
        t2 = Linear(self.dim_feedforward, param_dtype=pd, name="linear1")(t2)
        act = jax.nn.relu if self.activation == "relu" else (
            lambda x: jax.nn.gelu(x, approximate=False))
        t2 = act(t2)
        t2 = Linear(self.d_model, param_dtype=pd, name="linear2")(t2)
        return tgt + t2


class MemoryAttention(nn.Module):
    """Layer stack with input pos enc 0.1*curr_pos (reference
    sam2/modeling/memory_attention.py:102-169)."""
    d_model: int
    num_heads: int
    num_layers: int = 4
    param_dtype: Dtype = jnp.float32
    dim_feedforward: Optional[int] = None  # default d_model*2 (fork config)
    activation: str = "gelu"
    pos_enc_at_cross_attn_queries: bool = True
    pos_enc_at_cross_attn_keys: bool = False

    @nn.compact
    def __call__(self, curr, memory, curr_pos, grid_hw,
                 mask: Optional[jnp.ndarray] = None,
                 memory_pos: Optional[jnp.ndarray] = None,
                 num_k_exclude_rope: int = 0):
        out = curr + 0.1 * curr_pos
        dff = self.dim_feedforward or self.d_model * 2
        for i in range(self.num_layers):
            out = MemoryAttentionLayer(
                self.d_model, self.num_heads, dff,
                self.param_dtype, self.activation,
                self.pos_enc_at_cross_attn_queries,
                self.pos_enc_at_cross_attn_keys,
                name=f"layers_{i}")(
                    out, memory, curr_pos, grid_hw, mask=mask,
                    memory_pos=memory_pos,
                    num_k_exclude_rope=num_k_exclude_rope)
        return LayerNorm(epsilon=1e-5, param_dtype=self.param_dtype,
                         name="norm")(out)


class MaskDownSampler(nn.Module):
    """One stride-s mask downsampling stage (reference
    sam2/modeling/memory_encoder.py:17-58): conv s -> token LN -> GELU ->
    1x1 conv to embed_dim.  Submodule names mirror the torch Sequential."""
    embed_dim: int
    kernel_size: int
    stride: int
    padding: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        out_ch = x.shape[-1] * self.stride ** 2
        x = Conv2d(out_ch, (self.kernel_size, self.kernel_size),
                   stride=(self.stride, self.stride), padding=self.padding,
                   param_dtype=self.param_dtype, name="encoder_0")(x)
        x = LayerNorm(epsilon=1e-6, param_dtype=self.param_dtype,
                      name="encoder_1")(x)
        x = jax.nn.gelu(x, approximate=False)
        return Conv2d(self.embed_dim, (1, 1), padding=0,
                      param_dtype=self.param_dtype, name="encoder_3")(x)


class CXBlock(nn.Module):
    """ConvNeXt block, NHWC (reference memory_encoder.py:62-119)."""
    dim: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        inp = x
        x = Conv2d(self.dim, (7, 7), padding=3, feature_group_count=self.dim,
                   param_dtype=self.param_dtype, name="dwconv")(x)
        x = LayerNorm(epsilon=1e-6, param_dtype=self.param_dtype,
                      name="norm")(x)
        x = Linear(4 * self.dim, param_dtype=self.param_dtype,
                   name="pwconv1")(x)
        x = jax.nn.gelu(x, approximate=False)
        x = Linear(self.dim, param_dtype=self.param_dtype, name="pwconv2")(x)
        gamma = self.param("gamma",
                           jax.nn.initializers.constant(1e-6),
                           (self.dim,), self.param_dtype)
        return inp + gamma.astype(x.dtype) * x


class Fuser(nn.Module):
    """Stack of CXBlocks (reference memory_encoder.py:122-135)."""
    dim: int
    num_layers: int = 2
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        for i in range(self.num_layers):
            x = CXBlock(self.dim, self.param_dtype, name=f"layers_{i}")(x)
        return x


class MemoryEncoder(nn.Module):
    """(feature, depth) -> (memory_feature, memory_pos_enc), both [B,HW,C]
    (reference memory_encoder.py:137-181 with the fork's two-stage stride
    2*7=14 mask downsampler, memory_block.py:68-77)."""
    channels: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, feature_map: jnp.ndarray, depth: jnp.ndarray):
        # feature_map [B, gh, gw, C]; depth [B, H, W, 1] at 14x grid res
        masks = jax.nn.sigmoid(depth.astype(jnp.float32)).astype(
            feature_map.dtype)
        masks = MaskDownSampler(1, 3, 2, 1, self.param_dtype,
                                name="mask_downsampler_0")(masks)
        masks = MaskDownSampler(1, 7, 7, 0, self.param_dtype,
                                name="mask_downsampler_1")(masks)
        x = Conv2d(self.channels, (1, 1), padding=0,
                   param_dtype=self.param_dtype,
                   name="pix_feat_proj")(feature_map)
        x = x + masks
        x = Fuser(self.channels, 2, self.param_dtype, name="fuser")(x)
        b, gh, gw, c = x.shape
        pos = jnp.asarray(sine_position_embedding_2d(gh, gw, c))
        pos = jnp.broadcast_to(pos[None], (b, gh, gw, c)).astype(x.dtype)
        return x.reshape(b, gh * gw, c), pos.reshape(b, gh * gw, c)


class MemoryBlock(nn.Module):
    """Memory-conditioned feature refinement
    (reference depth_anything_v2/memory_block.py:12-125)."""
    channels: int
    max_memory_length: int = 6
    num_attention_layers: int = 4
    param_dtype: Dtype = jnp.float32

    def setup(self):
        pd = self.param_dtype
        c = self.channels
        self.memory_attention = MemoryAttention(
            c, c // 64, self.num_attention_layers, pd)
        self.curr_pos_enc = self.param(
            "curr_pos_enc", jax.nn.initializers.normal(0.02), (1, 1, c), pd)
        self.maskmem_tpos_enc = self.param(
            "maskmem_tpos_enc", jax.nn.initializers.normal(0.02),
            (1, self.max_memory_length, c), pd)
        self.no_mem_embed = self.param(
            "no_mem_embed", jax.nn.initializers.normal(0.02), (1, 1, c), pd)
        self.memory_encoder = MemoryEncoder(c, pd)

    def __call__(self, img_feature: jnp.ndarray, grid_hw: Tuple[int, int],
                 state: Optional[Dict] = None) -> jnp.ndarray:
        """img_feature [B, HW, C]; state None = empty-memory branch
        (reference memory_block.py:115-123)."""
        b, hw, c = img_feature.shape
        curr_pos = jnp.broadcast_to(
            self.curr_pos_enc.astype(img_feature.dtype), (b, hw, c))
        if state is None:
            memory = jnp.broadcast_to(
                self.no_mem_embed.astype(img_feature.dtype), (b, hw, c))
            return self.memory_attention(img_feature, memory, curr_pos,
                                         grid_hw)
        cap = state["features"].shape[1]
        # tpos enc per slot: newest slot (last) gets index cap-1 — identical
        # to the reference's max_len - S + i assignment for a right-aligned
        # buffer (memory_block.py:101)
        mem = state["features"].astype(img_feature.dtype)
        mem = mem.reshape(b, cap * hw, c)
        # mask invalid (not-yet-written) slots out of the softmax
        slot_valid = (jnp.arange(cap) >= cap - state["count"])
        mask = jnp.repeat(slot_valid, hw)[None, None, None, :]
        return self.memory_attention(img_feature, mem, curr_pos, grid_hw,
                                     mask=mask)

    def encode(self, img_feature: jnp.ndarray, depth: jnp.ndarray,
               grid_hw: Tuple[int, int]):
        """-> (memory_feature [B,HW,C], memory_pos_enc [B,HW,C]); the pos
        enc includes the per-slot tpos term at *read* time, not here."""
        b, hw, c = img_feature.shape
        gh, gw = grid_hw
        fmap = img_feature.reshape(b, gh, gw, c)
        return self.memory_encoder(fmap, depth)
