"""DPT decoder head (NHWC).

Re-design of the reference DPT stack (reference depth_anything_v2/dpt.py:37-151
and util/blocks.py:4-148): 4 intermediate ViT features are projected,
resampled to a 4-level pyramid, and fused top-down through refinenet blocks
with align_corners bilinear upsampling, ending in the output convs.

Module names mirror the reference checkpoint keys (projects_i, resize_layers_i,
scratch.layerN_rn, scratch.refinenetN, scratch.output_conv1/2) so
vdn.core.convert maps weights mechanically.

The final output convs run in fp32 — the reference forces this island out of
autocast in the temporal head (dpt_temporal.py:108-110); we apply the same
policy to every head.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.layers import Conv2d, ConvTranspose2d
from vdn.ops.resize import resize2d

Dtype = Any


class ResidualConvUnit(nn.Module):
    features: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        y = jax.nn.relu(x)
        y = Conv2d(self.features, (3, 3), padding=1,
                   param_dtype=self.param_dtype, name="conv1")(y)
        y = jax.nn.relu(y)
        y = Conv2d(self.features, (3, 3), padding=1,
                   param_dtype=self.param_dtype, name="conv2")(y)
        return y + x


class FeatureFusionBlock(nn.Module):
    features: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, skip=None, size: Optional[Tuple[int, int]] = None):
        out = x
        if skip is not None:
            out = out + ResidualConvUnit(self.features, self.param_dtype,
                                         name="resConfUnit1")(skip)
        out = ResidualConvUnit(self.features, self.param_dtype,
                               name="resConfUnit2")(out)
        if size is None:
            size = (out.shape[-3] * 2, out.shape[-2] * 2)
        # out_conv (1x1) commutes exactly with bilinear interpolation (the
        # resize is per-channel linear with align-corners weights summing
        # to 1, so conv(resize(x)) == resize(conv(x)) incl. the bias);
        # applying it BEFORE the upsample quarters its FLOPs vs the
        # reference order (util/blocks.py:134-148)
        out = Conv2d(self.features, (1, 1), padding=0,
                     param_dtype=self.param_dtype, name="out_conv")(out)
        return resize2d(out, size, "bilinear", align_corners=True)


class Scratch(nn.Module):
    """Container matching the reference's `scratch` nn.Module namespace.

    ``sigmoid_output`` selects the metric-depth head variant: the final
    activation becomes a sigmoid scaled by max_depth at the model level
    (reference metric_depth/depth_anything_v2/dpt.py:109-114)."""
    features: int
    out_channels: Sequence[int]
    param_dtype: Dtype = jnp.float32
    sigmoid_output: bool = False
    remat: bool = False

    def setup(self):
        f, pd = self.features, self.param_dtype
        self.layer1_rn = Conv2d(f, (3, 3), padding=1, use_bias=False,
                                param_dtype=pd)
        self.layer2_rn = Conv2d(f, (3, 3), padding=1, use_bias=False,
                                param_dtype=pd)
        self.layer3_rn = Conv2d(f, (3, 3), padding=1, use_bias=False,
                                param_dtype=pd)
        self.layer4_rn = Conv2d(f, (3, 3), padding=1, use_bias=False,
                                param_dtype=pd)
        # remat: rematerialize the high-resolution refinenet tail during
        # backward — its 296^2-grid activations dominate training memory
        # (the round-1 B=2 OOM); the reference instead micro-batches the
        # tail at inference (dpt_temporal.py:98-125)
        # (size is arg 3 counting self; it is a static shape tuple)
        ffb = nn.remat(FeatureFusionBlock, static_argnums=(3,)) \
            if self.remat else FeatureFusionBlock
        self.refinenet1 = ffb(f, pd)
        self.refinenet2 = ffb(f, pd)
        self.refinenet3 = ffb(f, pd)
        self.refinenet4 = ffb(f, pd)
        self.output_conv1 = Conv2d(f // 2, (3, 3), padding=1, param_dtype=pd)
        # fp32 *accumulation* island: under bf16 compute the operands
        # (input feature AND this conv's weights) are rounded to bf16 and
        # only the accumulator/output is fp32 — a deliberate deviation
        # from the reference's fully-fp32 island (dpt_temporal.py:108-110)
        # for the bf16 tensor-core rate and no 518^2x128 fp32 convert; the
        # bf16-vs-fp32 drift of this path is bounded by
        # tests/test_dpt.py::test_output_island_bf16_drift.  Under fp32
        # compute the island's dots run at the default precision (TF32 on
        # the GPU; see vdn/core/dtypes.py)
        self.output_conv2_0 = Conv2d(32, (3, 3), padding=1, param_dtype=pd,
                                     accum_dtype=jnp.float32)
        self.output_conv2_2 = Conv2d(1, (1, 1), padding=0, param_dtype=pd)

    def fuse(self, layers: Sequence[jnp.ndarray]):
        """Top-down refinenet path; returns path_1 (finest fused feature)."""
        l1, l2, l3, l4 = layers
        r1 = self.layer1_rn(l1)
        r2 = self.layer2_rn(l2)
        r3 = self.layer3_rn(l3)
        r4 = self.layer4_rn(l4)
        p4 = self.refinenet4(r4, None, tuple(r3.shape[-3:-1]))
        p3 = self.refinenet3(p4, r3, tuple(r2.shape[-3:-1]))
        p2 = self.refinenet2(p3, r2, tuple(r1.shape[-3:-1]))
        p1 = self.refinenet1(p2, r1, None)
        return p1

    def output_head(self, path_1, out_hw: Tuple[int, int],
                    final_act: Optional[Callable] = None):
        """conv1 -> align_corners-bilinear to (14*ph, 14*pw) -> fp32 convs.

        ``final_act`` replaces the head's activation (the identity gives
        the pre-activation output).
        Returns (depth [B,H,W,1] fp32, upscaled feature)."""
        out = self.output_conv1(path_1)
        # fp32-accumulation island (cf. reference dpt_temporal.py:108-110):
        # compute-dtype operands, fp32 accumulator + fp32 activations from
        # here to the output (see the output_conv2_0 note in setup)
        act = final_act or (jax.nn.sigmoid if self.sigmoid_output
                            else jax.nn.relu)
        o_ch = 32
        if 128 % o_ch == 0 and 128 // o_ch > 1:
            # lane-packed island (vdn/ops/packed_conv.py)
            w1, b1 = self.output_conv2_0(out, params_only=True)
            w2, b2 = self.output_conv2_2(
                jnp.zeros(out.shape[:-1] + (o_ch,), out.dtype),
                params_only=True)
            from vdn.ops.packed_conv import packed_island_head
            up = resize2d(out, out_hw, "bilinear", align_corners=True)
            return packed_island_head(up, w1, b1, w2[0, 0], b2, act), up
        out = resize2d(out, out_hw, "bilinear", align_corners=True)
        y = self.output_conv2_0(out)
        y = jax.nn.relu(y)
        y = self.output_conv2_2(y)
        return act(y), out


class DPTHead(nn.Module):
    """features: fused channel width; out_channels: pyramid widths.

    ``__call__`` takes the 4 intermediate (tokens, cls) pairs from the ViT
    and the patch grid, returns (depth [B, 14ph, 14pw, 1] fp32, feature).
    """
    in_channels: int
    features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    param_dtype: Dtype = jnp.float32
    sigmoid_output: bool = False
    remat: bool = False

    def setup(self):
        pd = self.param_dtype
        oc = self.out_channels
        self.projects_0 = Conv2d(oc[0], (1, 1), padding=0, param_dtype=pd)
        self.projects_1 = Conv2d(oc[1], (1, 1), padding=0, param_dtype=pd)
        self.projects_2 = Conv2d(oc[2], (1, 1), padding=0, param_dtype=pd)
        self.projects_3 = Conv2d(oc[3], (1, 1), padding=0, param_dtype=pd)
        self.resize_layers_0 = ConvTranspose2d(oc[0], (4, 4), (4, 4),
                                               param_dtype=pd)
        self.resize_layers_1 = ConvTranspose2d(oc[1], (2, 2), (2, 2),
                                               param_dtype=pd)
        # resize_layers_2 is Identity in the reference
        self.resize_layers_3 = Conv2d(oc[3], (3, 3), stride=(2, 2),
                                      padding=1, param_dtype=pd)
        self.scratch = Scratch(self.features, oc, pd,
                               self.sigmoid_output, self.remat)

    def project_features(self, out_features, patch_h: int, patch_w: int):
        """tokens [B, ph*pw, C] x4 -> pyramid of NHWC maps."""
        maps = []
        projects = [self.projects_0, self.projects_1, self.projects_2,
                    self.projects_3]
        resizes = [self.resize_layers_0, self.resize_layers_1,
                   lambda x: x, self.resize_layers_3]
        for i, item in enumerate(out_features):
            tokens = item[0] if isinstance(item, (tuple, list)) else item
            b = tokens.shape[0]
            x = tokens.reshape(b, patch_h, patch_w, tokens.shape[-1])
            x = projects[i](x)
            x = resizes[i](x)
            maps.append(x)
        return maps

    def __call__(self, out_features, patch_h: int, patch_w: int):
        layers = self.project_features(out_features, patch_h, patch_w)
        path_1 = self.scratch.fuse(layers)
        return self.scratch.output_head(
            path_1, (patch_h * 14, patch_w * 14))
