"""Hiera hierarchical ViT backbone (SAM2 variant).

Re-design of reference sam2/modeling/backbones/hieradet.py:25-317: windowed
multi-scale attention with q-pooling at stage changes, global attention at
fixed block indices, windowed background positional embedding.  NHWC
throughout; window partitioning is reshape+transpose (XLA fuses these).

The fork's v1 research model uses the MAE-pretrained torch-hub Hiera
(reference models/hiera_image_encoder.py:35 — fetched over the network at
runtime); vdn standardizes on this SAM2 Hiera variant, which shares the
stage structure / channel pyramid (96/192/384/768 at strides 4/8/16/32)
and has in-repo reference semantics to test against.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vdn.nn import module as nn
from vdn.nn.layers import Conv2d, LayerNorm, Linear
from vdn.ops.attention import dot_product_attention
from vdn.ops.resize import resize2d

Dtype = Any

HIERA_CONFIGS = {
    # sam2 yaml configs (tiny/small/b+/large)
    "hiera_tiny": dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                       global_att_blocks=(5, 7, 9),
                       window_pos_embed_bkg_spatial_size=(7, 7)),
    "hiera_small": dict(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
                        global_att_blocks=(7, 10, 13),
                        window_pos_embed_bkg_spatial_size=(7, 7)),
    "hiera_base": dict(embed_dim=96, num_heads=1, stages=(2, 3, 16, 3),
                       global_att_blocks=(12, 16, 20),
                       window_pos_embed_bkg_spatial_size=(14, 14)),
    "hiera_base_plus": dict(embed_dim=112, num_heads=2,
                            stages=(2, 3, 16, 3),
                            global_att_blocks=(12, 16, 20),
                            window_pos_embed_bkg_spatial_size=(14, 14)),
    "hiera_large": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
                        global_att_blocks=(23, 33, 43),
                        window_spec=(8, 4, 16, 8),
                        window_pos_embed_bkg_spatial_size=(7, 7)),
    # not a released variant: 4-block toy for tests/CI (XLA CPU compiles
    # the hiera_tiny v1 train step in ~4.5 min; this one in seconds)
    "hiera_test": dict(embed_dim=32, num_heads=1, stages=(1, 1, 1, 1),
                       global_att_blocks=(2,),
                       window_pos_embed_bkg_spatial_size=(7, 7)),
}


def window_partition(x: jnp.ndarray, window_size: int):
    """[B, H, W, C] -> ([B*nW, ws, ws, C], (Hp, Wp))
    (reference backbones/utils.py:16-36)."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = jnp.pad(x, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size,
                  wp // window_size, window_size, c)
    win = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                                window_size, c)
    return win, (hp, wp)


def window_unpartition(win: jnp.ndarray, window_size: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // ((hp // window_size) * (wp // window_size))
    x = win.reshape(b, hp // window_size, wp // window_size,
                    window_size, window_size, -1)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _max_pool_2x2(x: jnp.ndarray, stride: Tuple[int, int]) -> jnp.ndarray:
    """NHWC max pool with kernel == stride (torch MaxPool2d ceil_mode=False
    drops incomplete windows; reduce_window 'VALID' matches)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1,) + tuple(stride) + (1,),
        (1,) + tuple(stride) + (1,), "VALID")


class HieraPatchEmbed(nn.Module):
    embed_dim: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        return Conv2d(self.embed_dim, (7, 7), stride=(4, 4), padding=3,
                      param_dtype=self.param_dtype, name="proj")(x)


class MultiScaleAttention(nn.Module):
    dim_out: int
    num_heads: int
    q_stride: Optional[Tuple[int, int]] = None
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, h, w, _ = x.shape
        nh = self.num_heads
        qkv = Linear(self.dim_out * 3, param_dtype=self.param_dtype,
                     name="qkv")(x)
        qkv = qkv.reshape(b, h * w, 3, nh, -1)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.q_stride is not None:
            q = _max_pool_2x2(q.reshape(b, h, w, -1), self.q_stride)
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, nh, -1)
        out = dot_product_attention(q, k, v)
        out = out.reshape(b, h, w, self.dim_out)
        return Linear(self.dim_out, param_dtype=self.param_dtype,
                      name="proj")(out)


class MultiScaleBlock(nn.Module):
    dim: int
    dim_out: int
    num_heads: int
    mlp_ratio: float = 4.0
    q_stride: Optional[Tuple[int, int]] = None
    window_size: int = 0
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        pd = self.param_dtype
        shortcut = x
        x = LayerNorm(epsilon=1e-6, param_dtype=pd, name="norm1")(x)
        if self.dim != self.dim_out:
            proj = Linear(self.dim_out, param_dtype=pd, name="proj")(x)
            if self.q_stride is not None:
                proj = _max_pool_2x2(proj, self.q_stride)
            shortcut = proj

        window_size = self.window_size
        h, w = x.shape[1:3]
        if window_size > 0:
            x, pad_hw = window_partition(x, window_size)

        x = MultiScaleAttention(self.dim_out, self.num_heads,
                                self.q_stride, pd, name="attn")(x)
        if self.q_stride is not None:
            window_size = self.window_size // self.q_stride[0]
            h, w = shortcut.shape[1:3]
            pad_h = (window_size - h % window_size) % window_size \
                if window_size else 0
            pad_w = (window_size - w % window_size) % window_size \
                if window_size else 0
            pad_hw = (h + pad_h, w + pad_w)

        if self.window_size > 0:
            x = window_unpartition(x, window_size, pad_hw, (h, w))

        x = shortcut + x
        y = LayerNorm(epsilon=1e-6, param_dtype=pd, name="norm2")(x)
        y = SamMLP(int(self.dim_out * self.mlp_ratio), self.dim_out, pd,
                   name="mlp")(y)
        return x + y


class SamMLP(nn.Module):
    """sam2_utils.MLP: layers.0 / layers.1 Linears with GELU between."""
    hidden: int
    out: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = Linear(self.hidden, param_dtype=self.param_dtype,
                   name="layers_0")(x)
        x = jax.nn.gelu(x, approximate=False)
        return Linear(self.out, param_dtype=self.param_dtype,
                      name="layers_1")(x)


class Hiera(nn.Module):
    embed_dim: int = 96
    num_heads: int = 1
    q_pool: int = 3
    q_stride: Tuple[int, int] = (2, 2)
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14, 14)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    param_dtype: Dtype = jnp.float32

    def setup(self):
        pd = self.param_dtype
        depth = sum(self.stages)
        self.stage_ends = [sum(self.stages[:i]) - 1
                           for i in range(1, len(self.stages) + 1)]
        self.q_pool_blocks = [e + 1 for e in
                              self.stage_ends[:-1]][:self.q_pool]
        # sam2 PatchEmbed: conv 7x7 stride 4 pad 3 (backbones/utils.py)
        self.patch_embed = HieraPatchEmbed(self.embed_dim, pd)
        self.pos_embed = self.param(
            "pos_embed", jax.nn.initializers.zeros,
            (1, *self.window_pos_embed_bkg_spatial_size, self.embed_dim),
            pd)
        self.pos_embed_window = self.param(
            "pos_embed_window", jax.nn.initializers.zeros,
            (1, self.window_spec[0], self.window_spec[0], self.embed_dim),
            pd)

        blocks = []
        dim = self.embed_dim
        heads = self.num_heads
        cur_stage = 1
        for i in range(depth):
            dim_out = dim
            window_size = self.window_spec[cur_stage - 1]
            if self.global_att_blocks and i in self.global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * self.dim_mul)
                heads = int(heads * self.head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(
                dim=dim, dim_out=dim_out, num_heads=heads,
                q_stride=self.q_stride if i in self.q_pool_blocks else None,
                window_size=window_size, param_dtype=pd,
                name=f"blocks_{i}"))
            dim = dim_out
        self.blocks = blocks

    def _get_pos_embed(self, hw: Tuple[int, int], dtype) -> jnp.ndarray:
        h, w = hw
        pos = resize2d(self.pos_embed.astype(jnp.float32), (h, w),
                       "bicubic", align_corners=False)
        win = self.pos_embed_window.astype(jnp.float32)
        reps = (1, h // win.shape[1], w // win.shape[2], 1)
        pos = pos + jnp.tile(win, reps)
        return pos.astype(dtype)

    def __call__(self, x: jnp.ndarray) -> List[jnp.ndarray]:
        """x [B, H, W, 3] -> per-stage NHWC features (strides 4/8/16/32)."""
        x = self.patch_embed(x)
        x = x + self._get_pos_embed(x.shape[1:3], x.dtype)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outputs.append(x)
        return outputs


def make_hiera(variant: str = "hiera_base", param_dtype=jnp.float32,
               **kw) -> Hiera:
    """kw may include flax module kwargs (e.g. name=) and config overrides."""
    cfg = dict(HIERA_CONFIGS[variant])
    cfg.update(kw)
    return Hiera(param_dtype=param_dtype, **cfg)
