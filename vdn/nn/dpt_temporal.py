"""Temporal DPT head: DPT decoder with four temporal mixers.

Re-design of the reference DPTHeadTemporal
(reference video_depth_anything/dpt_temporal.py:22-127): TemporalModules are
inserted after the layer_3 / layer_4 projections and after refinenet4 /
refinenet3, threading a KV-cache pytree through them for streaming decode.

The reference's 4-frame micro-batching of the refinenet tail
(dpt_temporal.py:98-125) exists to bound CUDA activation memory; under XLA
we instead rely on fusion + optional remat, keeping the whole window batched
on the device.  Its fp32 output island (output_conv2) is preserved in
Scratch.output_head.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.dpt import DPTHead
from vdn.nn.motion import TemporalModule

Dtype = Any

# cache entries produced per TemporalModule (1 transformer block x 2 attns)
CACHE_ENTRIES_PER_MODULE = 2
NUM_MOTION_MODULES = 4
NUM_CACHE_ENTRIES = CACHE_ENTRIES_PER_MODULE * NUM_MOTION_MODULES


class DPTHeadTemporal(DPTHead):
    num_frames: int = 32
    pe: str = "ape"
    seq_axis: Optional[str] = None

    def setup(self):
        super().setup()
        kw = dict(num_attention_heads=8, num_transformer_block=1,
                  num_attention_blocks=CACHE_ENTRIES_PER_MODULE,
                  temporal_max_len=self.num_frames,
                  pos_embedding_type=self.pe, param_dtype=self.param_dtype,
                  seq_axis=self.seq_axis)
        oc = self.out_channels
        self.motion_modules_0 = TemporalModule(oc[2], **kw)
        self.motion_modules_1 = TemporalModule(oc[3], **kw)
        self.motion_modules_2 = TemporalModule(self.features, **kw)
        self.motion_modules_3 = TemporalModule(self.features, **kw)

    def __call__(self, out_features, patch_h: int, patch_w: int,
                 frame_length: int,
                 caches: Optional[Sequence[jnp.ndarray]] = None,
                 cache_len: Optional[int] = None):
        """Returns (depth [(B*T), 14ph, 14pw, 1] fp32, new_caches tuple(8)).

        ``cache_len``: with seq_axis set and caches given (context-parallel
        streaming), the number of logically valid cache entries across the
        whole seq axis (caches are each device's local shard, zero-padded
        so the window length divides the axis size)."""
        r1, r2, l3, l4 = self.decode_pre(out_features, patch_h, patch_w)
        p3, new_caches = self.decode_temporal(
            l3, l4, tuple(r2.shape[-3:-1]), frame_length, caches, cache_len)
        depth = self.decode_post(p3, r1, r2, (patch_h * 14, patch_w * 14))
        return depth, new_caches

    # The three stages below exist so streaming decode can scan ONLY the
    # frame-sequential middle (the motion modules + the two coarsest
    # refinenets, all at <=1/8 output resolution) while batching the
    # frame-independent stages over the whole chunk — the full-resolution
    # tail (refinenet2/1 + output island) dominates per-frame decode cost
    # and has no cross-frame dependency.  __call__ composes them, so the
    # clip path and the reference order are unchanged.

    def decode_pre(self, out_features, patch_h: int, patch_w: int):
        """Frame-independent head: projections + the l1/l2 RCU convs."""
        l1, l2, l3, l4 = self.project_features(out_features, patch_h, patch_w)
        r1 = self.scratch.layer1_rn(l1)
        r2 = self.scratch.layer2_rn(l2)
        return r1, r2, l3, l4

    def decode_temporal(self, l3, l4, r2_hw, frame_length: int,
                        caches: Optional[Sequence[jnp.ndarray]] = None,
                        cache_len: Optional[int] = None):
        """Frame-sequential middle: all four temporal mixers and the
        refinenet4/3 fusion between them.  Returns (p3 at r2 resolution,
        new cache entries tuple(8))."""
        t = frame_length
        n = (len(caches) // NUM_MOTION_MODULES) if caches is not None else 0

        def sub(i):
            return caches[i * n:(i + 1) * n] if n else None

        l3, h0 = self.motion_modules_0(l3, t, sub(0), cache_len)
        l4, h1 = self.motion_modules_1(l4, t, sub(1), cache_len)
        r3 = self.scratch.layer3_rn(l3)
        r4 = self.scratch.layer4_rn(l4)
        p4 = self.scratch.refinenet4(r4, None, tuple(r3.shape[-3:-1]))
        p4, h2 = self.motion_modules_2(p4, t, sub(2), cache_len)
        p3 = self.scratch.refinenet3(p4, r3, tuple(r2_hw))
        p3, h3 = self.motion_modules_3(p3, t, sub(3), cache_len)
        return p3, tuple(h0 + h1 + h2 + h3)

    def decode_post(self, p3, r1, r2, out_hw,
                    final_act: Optional[Callable] = None):
        """Frame-independent full-resolution tail (``final_act``: see
        Scratch.output_head)."""
        p2 = self.scratch.refinenet2(p3, r2, tuple(r1.shape[-3:-1]))
        p1 = self.scratch.refinenet1(p2, r1, None)
        depth, _ = self.scratch.output_head(p1, out_hw, final_act)
        return depth
