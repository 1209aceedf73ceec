"""Research video-depth heads for the v1 model family.

Re-design of:
- reference models/video_depth_head_v2_sangyu.py:8-318 — the head the v1
  model actually uses: interleaved Temporal/Spatial transformer layers on
  selected Hiera pyramid levels + UpSampleAdd skip decoder -> 3 channels
  (depth, dx, dy).  (The reference file has a latent missing-`math`-import
  bug in its sine branch, :11; fixed here.)
- reference models/video_depth_head.py:9-263 — head v1: temporal MHA over
  patch tokens + MLP fusion + ConvTranspose decoder.
- reference models/fusion_block.py:4-129 — FusionLayer (5-D per-sequence
  refinement block).

BatchNorms run in inference mode with stored running stats (the canonical
trainer targets the v4 model; see vdn.models.refine.BatchNorm2d).
NHWC feature maps: [B, S, H, W, C].
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vdn.models.refine import BatchNorm2d
from vdn.nn import module as nn
from vdn.nn.layers import Conv2d, ConvTranspose2d, LayerNorm, Linear
from vdn.ops.attention import dot_product_attention
from vdn.ops.resize import resize2d

Dtype = Any


def sinusoid_table(length: int, dim: int) -> np.ndarray:
    """(reference video_depth_head_v2_sangyu.py:8-15, with math imported)"""
    position = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * -(math.log(10000.0) / dim))
    emb = np.zeros((length, dim))
    emb[:, 0::2] = np.sin(position * div)
    emb[:, 1::2] = np.cos(position * div)
    return emb.astype(np.float32)


class MultiheadSelfAttention(nn.Module):
    """torch nn.MultiheadAttention (self-attention, batch_first) with the
    packed in_proj layout so checkpoints map 1:1."""
    dim: int
    num_heads: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):  # [B, T, C]
        b, t, c = x.shape
        qkv = Linear(3 * c, param_dtype=self.param_dtype,
                     name="in_proj")(x)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        h = self.num_heads
        dh = c // h
        out = dot_product_attention(q.reshape(b, t, h, dh),
                                    k.reshape(b, t, h, dh),
                                    v.reshape(b, t, h, dh))
        out = out.reshape(b, t, c)
        return Linear(c, param_dtype=self.param_dtype, name="out_proj")(out)


class TransformerBlock(nn.Module):
    """Pre-norm MHA + FFN (reference _sangyu.py:34-76)."""
    dim: int
    num_heads: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        pd = self.param_dtype
        y = LayerNorm(epsilon=1e-5, param_dtype=pd, name="norm1")(x)
        y = MultiheadSelfAttention(self.dim, self.num_heads, pd,
                                   name="multi_head_attention")(y)
        x = x + y
        y = LayerNorm(epsilon=1e-5, param_dtype=pd, name="norm2")(x)
        y = Linear(self.dim * 4, param_dtype=pd, name="ffn_0")(y)
        y = jax.nn.gelu(y, approximate=False)
        y = Linear(self.dim, param_dtype=pd, name="ffn_2")(y)
        return x + y


class _AxisAttentionStack(nn.Module):
    """Shared machinery of Temporal/Spatial layers: N TransformerBlocks
    over a chosen axis arrangement of [B, S, H, W, C]."""
    dim: int
    num_heads: int = 8
    num_blocks: int = 4
    temporal: bool = True
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        b, s, h, w, c = x.shape
        if self.temporal:  # (b h w) s c
            y = x.transpose(0, 2, 3, 1, 4).reshape(b * h * w, s, c)
        else:  # (b s) (h w) c
            y = x.reshape(b * s, h * w, c)
        for i in range(self.num_blocks):
            y = TransformerBlock(self.dim, self.num_heads, self.param_dtype,
                                 name=f"transformer_blocks_{i}")(y)
        if self.temporal:
            y = y.reshape(b, h, w, s, c).transpose(0, 3, 1, 2, 4)
        else:
            y = y.reshape(b, s, h, w, c)
        return y


class UpSampleAdd(nn.Module):
    """bilinear 2x up + 3x3 conv/BN/relu + 1x1 skip projection add
    (reference _sangyu.py:17-32)."""
    out_ch: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, skip):  # NHWC
        pd = self.param_dtype
        x = resize2d(x, (x.shape[-3] * 2, x.shape[-2] * 2), "bilinear",
                     align_corners=True)
        x = Conv2d(self.out_ch, (3, 3), padding=1, use_bias=False,
                   param_dtype=pd, name="conv_0")(x)
        x = jax.nn.relu(BatchNorm2d(self.out_ch, param_dtype=pd,
                                    name="conv_1")(x))
        return x + Conv2d(self.out_ch, (1, 1), padding=0, param_dtype=pd,
                          name="skip_proj")(skip)


class VideoDepthHeadSangyu(nn.Module):
    """The v1 model's head (reference VideoDepthAnythingHeadV2 in
    _sangyu.py:179-318): per-level (Temporal-Spatial)x2 attention on
    ``attention_feature_levels``, top-down UpSampleAdd decoding, final
    4x upsample to (depth, dx, dy)."""
    sequence_length: int = 8
    pe: str = "ape"
    attention_feature_levels: Sequence[int] = (2, 3)
    feature_channels: Sequence[int] = (96, 192, 384, 768)
    param_dtype: Dtype = jnp.float32

    def setup(self):
        pd = self.param_dtype
        ch = self.feature_channels
        if self.pe == "ape":
            self.pos_embeds_0 = self.param(
                "pos_embeds_0", jax.nn.initializers.normal(0.02),
                (self.sequence_length, ch[0]), pd)
            self.pos_embeds_1 = self.param(
                "pos_embeds_1", jax.nn.initializers.normal(0.02),
                (self.sequence_length, ch[1]), pd)
            self.pos_embeds_2 = self.param(
                "pos_embeds_2", jax.nn.initializers.normal(0.02),
                (self.sequence_length, ch[2]), pd)
            self.pos_embeds_3 = self.param(
                "pos_embeds_3", jax.nn.initializers.normal(0.02),
                (self.sequence_length, ch[3]), pd)
        kw = dict(num_heads=8, num_blocks=4, param_dtype=pd)
        self.temporal_layers_first = [
            _AxisAttentionStack(ch[i], temporal=True, **kw,
                                name=f"temporal_layers_first_{i}")
            for i in range(4)]
        self.temporal_layers_second = [
            _AxisAttentionStack(ch[i], temporal=True, **kw,
                                name=f"temporal_layers_second_{i}")
            for i in range(4)]
        self.spatial_layers_first = [
            _AxisAttentionStack(ch[i], temporal=False, **kw,
                                name=f"spatial_layers_first_{i}")
            for i in range(4)]
        self.spatial_layers_second = [
            _AxisAttentionStack(ch[i], temporal=False, **kw,
                                name=f"spatial_layers_second_{i}")
            for i in range(4)]
        self.upscale_layers_0 = UpSampleAdd(ch[2], pd)
        self.upscale_layers_1 = UpSampleAdd(ch[1], pd)
        self.upscale_layers_2 = UpSampleAdd(ch[0], pd)
        # final_upscale_layer Sequential (indices match torch keys)
        self.final_upscale_layer_1 = Conv2d(ch[0], (3, 3), padding=1,
                                            use_bias=False, param_dtype=pd)
        self.final_upscale_layer_2 = BatchNorm2d(ch[0], param_dtype=pd)
        self.final_upscale_layer_5 = Conv2d(ch[0], (3, 3), padding=1,
                                            use_bias=False, param_dtype=pd)
        self.final_upscale_layer_6 = BatchNorm2d(ch[0], param_dtype=pd)
        self.final_upscale_layer_8 = Conv2d(48, (3, 3), padding=1,
                                            param_dtype=pd)
        self.final_upscale_layer_10 = Conv2d(3, (3, 3), padding=1,
                                             param_dtype=pd)
        # fusion_layer convs exist in checkpoints but are unused in the
        # reference forward (_sangyu.py:272-276) — kept for key parity
        self.fusion_layer_0 = Conv2d(ch[0], (3, 3), padding=1,
                                     param_dtype=pd)
        self.fusion_layer_1 = Conv2d(ch[1], (3, 3), padding=1,
                                     param_dtype=pd)
        self.fusion_layer_2 = Conv2d(ch[2], (3, 3), padding=1,
                                     param_dtype=pd)

    def _maybe_process(self, lvl: int, feat: jnp.ndarray) -> jnp.ndarray:
        if lvl not in self.attention_feature_levels:
            return feat
        b, s, h, w, c = feat.shape
        if self.pe == "ape":
            pe = [self.pos_embeds_0, self.pos_embeds_1, self.pos_embeds_2,
                  self.pos_embeds_3][lvl][:s]
            feat = feat + pe[None, :, None, None, :].astype(feat.dtype)
        elif self.pe == "sine":
            pe = jnp.asarray(sinusoid_table(s, c))
            feat = feat + pe[None, :, None, None, :].astype(feat.dtype)
        feat = self.temporal_layers_first[lvl](feat)
        feat = self.spatial_layers_first[lvl](feat)
        feat = self.temporal_layers_second[lvl](feat)
        feat = self.spatial_layers_second[lvl](feat)
        return feat

    def __call__(self, features: Sequence[jnp.ndarray]) -> jnp.ndarray:
        """features: 4 x [B, S, H_i, W_i, C_i] (strides 4..32) ->
        [B, S, H/1, W/1, 3] at 1x the stride-4 resolution."""
        assert len(features) == 4
        processed = [self._maybe_process(i, f)
                     for i, f in enumerate(features)]
        top = processed[3]
        b, s = top.shape[:2]
        flat = lambda f: f.reshape(b * s, *f.shape[2:])
        x = flat(top)
        x = self.upscale_layers_0(x, flat(processed[2]))
        x = self.upscale_layers_1(x, flat(processed[1]))
        x = self.upscale_layers_2(x, flat(processed[0]))
        x = resize2d(x, (x.shape[-3] * 2, x.shape[-2] * 2), "bilinear",
                     align_corners=True)
        x = jax.nn.relu(self.final_upscale_layer_2(
            self.final_upscale_layer_1(x)))
        x = resize2d(x, (x.shape[-3] * 2, x.shape[-2] * 2), "bilinear",
                     align_corners=True)
        x = jax.nn.relu(self.final_upscale_layer_6(
            self.final_upscale_layer_5(x)))
        x = jax.nn.relu(self.final_upscale_layer_8(x))
        x = self.final_upscale_layer_10(x)
        return x.reshape(b, s, *x.shape[1:])


class VideoDepthHeadV1(nn.Module):
    """Head v1 (reference models/video_depth_head.py:9-263): temporal MHA
    over patch tokens + residual MLP fusion + ConvTranspose/BN decoder to
    (depth, dx, dy)."""
    input_dim: int
    sequence_length: int = 8
    img_size: Tuple[int, int] = (384, 384)
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, features: jnp.ndarray) -> jnp.ndarray:
        """features [B*S, N, D] -> [B, S, H, W, 3]."""
        pd = self.param_dtype
        bs, n, d = features.shape
        s = self.sequence_length
        b = bs // s
        ph = self.img_size[0] // 14
        pw = self.img_size[1] // 14
        x = features.reshape(b, s, n, d)
        # temporal attention per token
        y = x.transpose(0, 2, 1, 3).reshape(b * n, s, d)
        y = MultiheadSelfAttention(d, 8, pd, name="temporal_attention")(y)
        x = y.reshape(b, n, s, d).transpose(0, 2, 1, 3)
        # st fusion (residual)
        f = Linear(d, param_dtype=pd, name="st_fusion_0")(x)
        f = jax.nn.relu(f)
        f = Linear(d, param_dtype=pd, name="st_fusion_3")(f)
        x = x + f
        # decode
        x = x.reshape(b * s, ph, pw, d)
        dims = [1024, 512, 256, 128]
        for i, ch in enumerate(dims):
            x = ConvTransposeTorch(ch, pd, name=f"decoder_{i}_0")(x)
            x = BatchNorm2d(ch, param_dtype=pd, name=f"decoder_{i}_1")(x)
            x = jax.nn.relu(x)
        x = Conv2d(64, (3, 3), padding=1, param_dtype=pd,
                   name="prediction_head_0")(x)
        x = jax.nn.relu(x)
        x = Conv2d(3, (3, 3), padding=1, param_dtype=pd,
                   name="prediction_head_2")(x)
        if x.shape[1:3] != self.img_size:
            x = resize2d(x, self.img_size, "bilinear", align_corners=False)
        return x.reshape(b, s, *self.img_size, 3)


class ConvTransposeTorch(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1) — the padded variant used by the
    v1 decoder; implemented as lhs-dilated conv with torch padding."""
    features: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        # torch convT(k=4, s=2, p=1): insert stride-1 zeros, pad k-1-p=2,
        # correlate with spatially flipped kernel (flip is baked into the
        # stored kernel by the converter, HWIO layout)
        kernel = self.param("kernel",
                            jax.nn.initializers.variance_scaling(
                                1 / 3, "fan_in", "uniform"),
                            (4, 4, x.shape[-1], self.features),
                            self.param_dtype)
        bias = self.param("bias", jax.nn.initializers.zeros,
                          (self.features,), self.param_dtype)
        y = jax.lax.conv_general_dilated(
            x, kernel.astype(x.dtype), window_strides=(1, 1),
            padding=[(2, 2), (2, 2)], lhs_dilation=(2, 2),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        # torch output size: (H-1)*2 - 2p + k = 2H; dilated output:
        # (2H-1) + 2*2 - 4 + 1 = 2H; matches
        return y + bias.astype(y.dtype)


class FusionLayer(nn.Module):
    """5-D per-sequence fusion block (reference models/fusion_block.py:61-129):
    upsample lhs (2x or to rhs_size), 3x3 in-conv, residual conv units on
    lhs/rhs, fuse, 1x1 out conv.  Input/output [B, S, H, W, C]."""
    out_channels: int
    rhs_size: Optional[Tuple[int, int]] = None
    align_corners: bool = True
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, lhs: jnp.ndarray,
                 rhs: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        from vdn.nn.dpt import ResidualConvUnit
        pd = self.param_dtype
        b, s = lhs.shape[:2]
        x = lhs.reshape(b * s, *lhs.shape[2:])
        if self.rhs_size is not None:
            size = self.rhs_size
        else:
            size = (x.shape[1] * 2, x.shape[2] * 2)
        x = resize2d(x, size, "bilinear", align_corners=self.align_corners)
        x = Conv2d(self.out_channels, (3, 3), padding=1, use_bias=False,
                   param_dtype=pd, name="lhs_in_conv")(x)
        out = ResidualConvUnit(self.out_channels, pd,
                               name="lhs_res_block")(x)
        if rhs is not None:
            r = rhs.reshape(b * s, *rhs.shape[2:])
            out = out + ResidualConvUnit(self.out_channels, pd,
                                         name="rhs_res_block")(r)
        out = ResidualConvUnit(self.out_channels, pd,
                               name="fusion_res_block")(out)
        out = Conv2d(self.out_channels, (1, 1), padding=0, param_dtype=pd,
                     name="out_conv")(out)
        return out.reshape(b, s, *out.shape[1:])


class VideoDepthHeadV2(nn.Module):
    """Head v2 (reference models/video_depth_head_v2.py:152-268, the active
    forward): temporal+spatial attention on the deepest Hiera level, then
    ConvTranspose/BN upscaling with concat-conv fusion against the raw
    skip features, final 4x ConvTranspose to (depth, dx, dy).

    Levels 0-2 temporal/spatial layers exist in checkpoints but are unused
    by the reference forward — instantiated here for key parity.
    """
    sequence_length: int = 8
    feature_channels: Sequence[int] = (96, 192, 384, 768)
    param_dtype: Dtype = jnp.float32

    def setup(self):
        pd = self.param_dtype
        ch = self.feature_channels
        self.temporal_layers = [
            _AxisAttentionStack(ch[i], 8, 2, temporal=True, param_dtype=pd,
                                name=f"temporal_layers_{i}")
            for i in range(4)]
        self.spatial_layers = [
            _AxisAttentionStack(ch[i], 8, 1, temporal=False, param_dtype=pd,
                                name=f"spatial_layers_{i}")
            for i in range(4)]
        self.upscale = [
            (ConvTransposeTorch(ch[i], pd, name=f"upscale_layers_{i}_0"),
             BatchNorm2d(ch[i], param_dtype=pd,
                         name=f"upscale_layers_{i}_1"))
            for i in range(3)]
        self.final_upscale_layer_0 = ConvTransposeTorch(
            ch[0] // 2, pd)
        self.final_upscale_layer_1 = BatchNorm2d(ch[0] // 2, param_dtype=pd)
        self.final_upscale_layer_3 = ConvTransposeTorch(3, pd)
        self.final_upscale_layer_4 = BatchNorm2d(3, param_dtype=pd)
        self.fusion_layer_0 = Conv2d(ch[0], (3, 3), padding=1,
                                     param_dtype=pd)
        self.fusion_layer_1 = Conv2d(ch[1], (3, 3), padding=1,
                                     param_dtype=pd)
        self.fusion_layer_2 = Conv2d(ch[2], (3, 3), padding=1,
                                     param_dtype=pd)

    def __call__(self, features: Sequence[jnp.ndarray]) -> jnp.ndarray:
        """features: 4 x [B, S, H_i, W_i, C_i] -> [B, S, 4*H_0, 4*W_0, 3]."""
        x = self.temporal_layers[3](features[3])
        x = self.spatial_layers[3](x)
        b, s = x.shape[:2]
        x = x.reshape(b * s, *x.shape[2:])
        fusions = [self.fusion_layer_0, self.fusion_layer_1,
                   self.fusion_layer_2]
        for i in reversed(range(3)):
            convt, bn = self.upscale[i]
            x = jax.nn.relu(bn(convt(x)))
            skip = features[i].reshape(b * s, *features[i].shape[2:])
            x = fusions[i](jnp.concatenate([x, skip], axis=-1))
        x = jax.nn.relu(self.final_upscale_layer_1(
            self.final_upscale_layer_0(x)))
        x = jax.nn.relu(self.final_upscale_layer_4(
            self.final_upscale_layer_3(x)))
        return x.reshape(b, s, *x.shape[1:])
