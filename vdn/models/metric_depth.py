"""Metric (absolute-scale) depth model.

The reference metric_depth subproject fine-tunes Depth-Anything-V2 with a
sigmoid-bounded head scaled by max_depth
(reference metric_depth/depth_anything_v2/dpt.py:109-114, :178-185 — note
the reference's own model class is commented out and its trainer imports a
nonexistent symbol, metric_depth/train.py:20; this is the intended model).
No memory block; plain single-image forward.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.dpt import DPTHead
from vdn.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit

Dtype = Any


class MetricDepthAnythingV2(nn.Module):
    encoder: str = "vitl"
    features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    max_depth: float = 20.0
    param_dtype: Dtype = jnp.float32
    compute_dtype: Dtype = jnp.float32
    remat: bool = False

    def setup(self):
        self.pretrained = make_vit(self.encoder, self.param_dtype,
                                   self.remat)
        self.depth_head = DPTHead(
            in_channels=self.pretrained.embed_dim, features=self.features,
            out_channels=self.out_channels, param_dtype=self.param_dtype,
            sigmoid_output=True, remat=self.remat)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        """x [B, H, W, 3] -> metric depth [B, H, W] in meters."""
        b, h, w, _ = x.shape
        ph, pw = h // 14, w // 14
        feats = self.pretrained.get_intermediate_layers(
            x.astype(self.compute_dtype),
            INTERMEDIATE_LAYER_IDX[self.encoder])
        depth, _ = self.depth_head(feats, ph, pw)
        return depth[..., 0].astype(jnp.float32) * self.max_depth
