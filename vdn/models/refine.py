"""Depth-refinement research models v2..v5.

Re-design of the reference refinement family (reference
models/video_depth_model_v2.py:37-100, _v3.py:128-206, _v4.py:88-148,
_v5.py:128-192): all take Depth-Anything depth maps as input (scaled by
1/65535), stack [depth, normal_x, normal_y] as a 3-channel image, run the
DINOv2 + temporal-DPT stack, and combine the output with the input through
small version-specific heads:

  v2: concat(out, input) -> 1x1 conv/BN/relu x2           (``final_res``)
  v3: input-scale head + zero-conv residual               (``final_scale2``/``final_res2``)
  v4: scale_head + zero-conv shift_head, x65535 output    (canonical)
  v5: v4 + internal 224x224 resize before the encoder

The per-frame global scale head is median-pool -> zero-conv ->
exp(tanh(x) * max_log_scale) (reference _v4.py:37-86).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.dpt_temporal import DPTHeadTemporal
from vdn.nn.layers import Conv2d
from vdn.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit
from vdn.ops.normals import normal_vector
from vdn.ops.resize import resize2d

Dtype = Any


def quantile_median(x: jnp.ndarray) -> jnp.ndarray:
    """torch.quantile(x, 0.5) over the last axis: linear-interpolated
    median (unlike torch.median's lower-median).  Radix select instead
    of a sort (vdn/ops/select.py)."""
    from vdn.ops.select import differentiable_value, kth_smallest

    n = x.shape[-1]
    pos = (n - 1) * 0.5
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    lo_v = differentiable_value(x, kth_smallest(x, lo + 1))
    if hi == lo or frac == 0.0:
        return lo_v
    hi_v = differentiable_value(x, kth_smallest(x, hi + 1))
    return lo_v * (1 - frac) + hi_v * frac


class ZeroConv(nn.Module):
    """1x1 conv initialized to zero (reference _v4.py:54-60)."""
    features: int = 1
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        kernel = self.param("kernel", jax.nn.initializers.zeros,
                            (1, 1, x.shape[-1], self.features),
                            self.param_dtype)
        bias = self.param("bias", jax.nn.initializers.zeros,
                          (self.features,), self.param_dtype)
        return (jax.lax.conv_general_dilated(
            x, kernel.astype(x.dtype), (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
            + bias.astype(x.dtype))


class GlobalScaleHead(nn.Module):
    """median pool -> ZeroConv -> exp(tanh * max_log_scale)
    (reference GlobalScaleHead, _v4.py:74-86).  x: [N, H, W, 1] ->
    [N, 1, 1, 1] positive scale."""
    max_log_scale: float = 1.0
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        n = x.shape[0]
        med = quantile_median(x.reshape(n, -1, x.shape[-1])
                              .transpose(0, 2, 1))  # [N, C]
        med = med[:, None, None, :]
        g = ZeroConv(1, self.param_dtype, name="feat_1")(med)
        return jnp.exp(jnp.tanh(g) * self.max_log_scale)


class BatchNorm2d(nn.Module):
    """Inference-mode BN over the channel axis with stored running stats
    (for the v2 ``final_res`` head; training of v2 is out of scope —
    the canonical trainer targets v4)."""
    features: int
    epsilon: float = 1e-5
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        scale = self.param("scale", jax.nn.initializers.ones,
                           (self.features,), self.param_dtype)
        bias = self.param("bias", jax.nn.initializers.zeros,
                          (self.features,), self.param_dtype)
        mean = self.param("running_mean", jax.nn.initializers.zeros,
                          (self.features,), self.param_dtype)
        var = self.param("running_var", jax.nn.initializers.ones,
                         (self.features,), self.param_dtype)
        inv = jax.lax.rsqrt(var.astype(jnp.float32) + self.epsilon)
        y = (x.astype(jnp.float32) - mean) * inv * scale + bias
        return y.astype(x.dtype)


class RefineVideoDepth(nn.Module):
    """Unified v2..v5 refinement model; ``version`` picks the head wiring."""
    version: int = 4
    encoder: str = "vitl"
    features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    num_frames: int = 32
    pe: str = "ape"
    max_depth: float = 65535.0
    use_residual: bool = True
    input_normal: bool = True
    internal_size: Optional[int] = None  # v5: 224
    param_dtype: Dtype = jnp.float32
    compute_dtype: Dtype = jnp.float32
    remat: bool = False

    def setup(self):
        assert self.version in (2, 3, 4, 5)
        pd = self.param_dtype
        self.pretrained = make_vit(self.encoder, pd, self.remat)
        head_name = "temporal_head" if self.version >= 4 else "head"
        head = DPTHeadTemporal(
            in_channels=self.pretrained.embed_dim, features=self.features,
            out_channels=self.out_channels, num_frames=self.num_frames,
            pe=self.pe, param_dtype=pd, remat=self.remat,
            name=head_name)
        if self.version >= 4:
            self.temporal_head = head
            self.scale_head = GlobalScaleHead(1.0, pd)
            self.shift_head_0 = ZeroConv(1, pd)
        elif self.version == 3:
            self.head = head
            self.final_scale2 = GlobalScaleHead(1.0, pd)
            self.final_res2_0 = ZeroConv(1, pd)
        else:  # v2
            self.head = head
            self.final_res_0 = Conv2d(1, (1, 1), padding=0, param_dtype=pd)
            self.final_res_1 = BatchNorm2d(1, param_dtype=pd)
            self.final_res_3 = Conv2d(1, (1, 1), padding=0, param_dtype=pd)
            self.final_res_4 = BatchNorm2d(1, param_dtype=pd)

    def _dpt_head(self):
        return self.temporal_head if self.version >= 4 else self.head

    def __call__(self, input_depth: jnp.ndarray) -> jnp.ndarray:
        """input_depth [B, S, H, W] (raw uint16-scale for v3/v4/v5) ->
        refined depth [B, S, H, W]."""
        b, s, h, w = input_depth.shape
        x = input_depth.astype(jnp.float32)
        if self.version != 2:
            x = x / self.max_depth
        else:
            x = x / 65535.0

        if self.version >= 3:
            scale_head = (self.scale_head if self.version >= 4
                          else self.final_scale2)
            flat = x.reshape(b * s, h, w, 1)
            scale = scale_head(flat).reshape(b, s, 1, 1)
            x = x * scale

        if self.internal_size is not None:  # v5
            enc_in = resize2d(x[..., None], (self.internal_size,
                                             self.internal_size),
                              "bilinear", align_corners=True)[..., 0]
        else:
            enc_in = x
        eh, ew = enc_in.shape[2:]

        if self.input_normal:
            normals = normal_vector(enc_in)  # [B,S,h,w,3]
            stacked = jnp.concatenate([enc_in[..., None],
                                       normals[..., :2]], axis=-1)
        else:
            stacked = jnp.repeat(enc_in[..., None], 3, axis=-1)

        frames = stacked.reshape(b * s, eh, ew, 3).astype(self.compute_dtype)
        ph, pw = eh // 14, ew // 14
        feats = self.pretrained.get_intermediate_layers(
            frames, INTERMEDIATE_LAYER_IDX[self.encoder])
        depth, _ = self._dpt_head()(feats, ph, pw, s)
        depth = resize2d(depth, (h, w), "bilinear", align_corners=True)
        depth = jax.nn.relu(depth.astype(jnp.float32))
        out = depth[..., 0].reshape(b, s, h, w)

        if self.use_residual:
            if self.version == 2:
                cat = jnp.stack([out, x], axis=-1).reshape(b * s, h, w, 2)
                y = self.final_res_0(cat)
                y = jax.nn.relu(self.final_res_1(y))
                y = self.final_res_3(y)
                y = jax.nn.relu(self.final_res_4(y))
                out = y[..., 0].reshape(b, s, h, w)
            else:
                res_head = (self.shift_head_0 if self.version >= 4
                            else self.final_res2_0)
                y = res_head(out.reshape(b * s, h, w, 1))
                out = x + y[..., 0].reshape(b, s, h, w)

        if self.version >= 4:
            out = out * self.max_depth
        return out


def match_seq_to_first_median(x: jnp.ndarray, eps: float = 1e-8,
                              scale: bool = True) -> jnp.ndarray:
    """Align frames 1..S-1 to frame 0's median/MAD
    (reference _v3.py:89-126; torch lower-median semantics)."""
    from vdn.ops.select import differentiable_value, kth_smallest

    b, s, h, w = x.shape
    flat = x.reshape(b, s, -1)
    n = flat.shape[-1]
    k = (n - 1) // 2 + 1  # torch lower median, via radix select
    med = differentiable_value(
        flat, kth_smallest(flat, k))[..., None, None]
    mad_flat = jnp.abs(x - med).reshape(b, s, -1)
    mad = differentiable_value(
        mad_flat, kth_smallest(mad_flat, k))[..., None, None]
    ref_med, ref_mad = med[:, :1], mad[:, :1]
    cur_med, cur_mad = med[:, 1:], mad[:, 1:]
    denom = jnp.where(cur_mad > eps, cur_mad, 1.0)
    if scale:
        rest = (x[:, 1:] - cur_med) / denom * ref_mad + ref_med
    else:
        rest = x[:, 1:] - cur_med + ref_med
    return jnp.concatenate([x[:, :1], rest], axis=1)
