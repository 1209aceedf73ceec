"""Single-image depth model with cross-frame memory.

Re-design of the reference DepthAnythingV2
(reference depth_anything_v2/depth_anything_v2.py:12-92): DINOv2 encoder,
memory attention on the last intermediate feature, DPT head.  The stateful
torch module (memory bank mutated inside forward) becomes a functional carry:

    depth, mem_feat = model.apply(params, x, state)        # state=None: no-mem
    new_entry = model.apply(params, mem_feat, depth, method=encode_memory)
    state = update_memory_state(state, *new_entry)

The host-side ergonomic wrapper lives in vdn.pipelines.infer_image.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.dpt import DPTHead
from vdn.nn.memory import MemoryBlock
from vdn.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit

Dtype = Any


class DepthAnythingV2(nn.Module):
    encoder: str = "vitl"
    features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    max_memory_length: int = 6
    num_mem_attention_layers: int = 4
    param_dtype: Dtype = jnp.float32
    compute_dtype: Dtype = jnp.float32
    remat: bool = False

    def setup(self):
        self.pretrained = make_vit(self.encoder, self.param_dtype,
                                   self.remat)
        self.memory_block = MemoryBlock(
            self.pretrained.embed_dim, self.max_memory_length,
            self.num_mem_attention_layers, self.param_dtype)
        self.depth_head = DPTHead(
            in_channels=self.pretrained.embed_dim, features=self.features,
            out_channels=self.out_channels, param_dtype=self.param_dtype,
            remat=self.remat)

    def __call__(self, x: jnp.ndarray, state: Optional[Dict] = None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """x [B, H, W, 3] -> (depth [B, H, W] fp32, memory-attended feature
        [B, HW, C] to be encoded into memory)."""
        b, h, w, _ = x.shape
        ph, pw = h // 14, w // 14
        feats = self.pretrained.get_intermediate_layers(
            x.astype(self.compute_dtype),
            INTERMEDIATE_LAYER_IDX[self.encoder])
        mem_feat = self.memory_block(feats[-1][0], (ph, pw), state)
        feats = feats[:-1] + [(mem_feat, feats[-1][1])]
        depth, _ = self.depth_head(feats, ph, pw)
        depth = jax.nn.relu(depth.astype(jnp.float32))
        return depth[..., 0], mem_feat

    def encode_memory(self, mem_feat: jnp.ndarray, depth: jnp.ndarray):
        """(feature [B,HW,C], depth [B,H,W]) -> (mem_feature, mem_pos),
        the new memory-bank entry (reference memory_block.py:83-90)."""
        # grid from the depth resolution (robust to non-square inputs)
        gh, gw = depth.shape[1] // 14, depth.shape[2] // 14
        return self.memory_block.encode(mem_feat, depth[..., None],
                                        (gh, gw))


def build_depth_anything_v2(encoder: str = "vitl", **kw) -> DepthAnythingV2:
    from vdn.models.presets import MODEL_CONFIGS
    cfg = dict(MODEL_CONFIGS[encoder])
    cfg.update(kw)
    return DepthAnythingV2(**cfg)
