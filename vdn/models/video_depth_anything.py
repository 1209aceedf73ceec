"""Video depth model: DINOv2 encoder + temporal DPT head.

Re-design of the reference VideoDepthAnything (clip forward:
reference video_depth_anything/video_depth.py:35-65; streaming split:
video_depth_stream.py:61-74).  Functional API:

- ``__call__(x)``: x [B, T, H, W, 3] -> depth [B, T, H, W] (clip mode)
- ``forward_features(x)``: ViT intermediate layers over flattened frames
- ``forward_depth(features, shape, caches)``: decode + new KV caches —
  the streaming building block (caches are fixed-shape pytrees; host
  orchestration lives in vdn.pipelines.stream)
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.dpt_temporal import DPTHeadTemporal
from vdn.nn.vit import INTERMEDIATE_LAYER_IDX, make_vit
from vdn.ops.resize import resize2d

Dtype = Any


class VideoDepthAnything(nn.Module):
    encoder: str = "vitl"
    features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    num_frames: int = 32
    pe: str = "ape"
    param_dtype: Dtype = jnp.float32
    compute_dtype: Dtype = jnp.float32
    remat: bool = False
    # mesh axis name for context-parallel temporal attention; the model
    # must then run under shard_map with the clip's T axis sharded on it
    # (vdn.parallel.context.make_context_parallel_forward)
    seq_axis: Optional[str] = None

    def setup(self):
        self.pretrained = make_vit(self.encoder, self.param_dtype,
                                   self.remat)
        self.head = DPTHeadTemporal(
            in_channels=self.pretrained.embed_dim, features=self.features,
            out_channels=self.out_channels, num_frames=self.num_frames,
            pe=self.pe, param_dtype=self.param_dtype,
            seq_axis=self.seq_axis, remat=self.remat)

    def forward_features(self, x: jnp.ndarray):
        """x: [B, T, H, W, 3] -> 4 x (tokens [(B*T), N, C], cls)."""
        b, t, h, w, c = x.shape
        flat = x.reshape(b * t, h, w, c).astype(self.compute_dtype)
        return self.pretrained.get_intermediate_layers(
            flat, INTERMEDIATE_LAYER_IDX[self.encoder])

    def forward_depth(self, features, x_shape: Tuple[int, ...],
                      caches: Optional[Sequence[jnp.ndarray]] = None,
                      cache_len: Optional[int] = None):
        """Decode features of T frames into depth [B, T, H, W] (fp32, relu'd)
        + the new cache pytree. T is the number of *new* frames.
        ``cache_len``: see DPTHeadTemporal (context-parallel streaming)."""
        b, t, h, w, _ = x_shape
        patch_h, patch_w = h // 14, w // 14
        depth, new_caches = self.head(features, patch_h, patch_w, t,
                                      caches=caches, cache_len=cache_len)
        depth = resize2d(depth, (h, w), "bilinear", align_corners=True)
        depth = jax.nn.relu(depth.astype(jnp.float32))
        return depth[..., 0].reshape(b, t, h, w), new_caches

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        features = self.forward_features(x)
        depth, _ = self.forward_depth(features, x.shape)
        return depth

    # -- windowed inference with cross-window encoder-feature reuse -----
    #
    # The reference window loop (video_depth.py:96-113) re-encodes the 10
    # KEYFRAMES seed frames of every window even though they are raw
    # frames that were already encoded by the previous window, and the
    # ViT encoder is frame-independent — their features are reusable
    # exactly.  forward_window returns the per-frame features alongside
    # the depth; forward_window_cached consumes the previous window's
    # gathered seed features and encodes only the new frames (the
    # temporal head still runs over the full window).  Outputs are
    # bit-identical to re-encoding; the pipeline gather lives in
    # vdn.pipelines.infer_video.

    def forward_window(self, x: jnp.ndarray):
        """x [B, T, H, W, 3] -> (depth [B, T, H, W], features)."""
        features = self.forward_features(x)
        depth, _ = self.forward_depth(features, x.shape)
        return depth, features

    def forward_window_cached(self, x_new: jnp.ndarray, seed_features):
        """Window forward over [seed ‖ new] frames; ``seed_features`` are
        previous-window encoder features for the first frames of this
        window (already gathered at the KEYFRAMES indices)."""
        b, t_new, h, w, c = x_new.shape
        t_seed = seed_features[0][0].shape[0] // b
        t = t_seed + t_new
        new_feats = self.forward_features(x_new)

        def cat(s, n):
            s = s.reshape(b, t_seed, *s.shape[1:])
            n = n.reshape(b, t_new, *n.shape[1:])
            return jnp.concatenate([s, n], axis=1).reshape(
                b * t, *s.shape[2:])

        features = [tuple(cat(s, n) for s, n in zip(sl, nl))
                    for sl, nl in zip(seed_features, new_feats)]
        depth, _ = self.forward_depth(features, (b, t, h, w, c))
        return depth, features


def build_video_depth_anything(encoder: str = "vitl", **kw
                               ) -> VideoDepthAnything:
    from vdn.models.presets import MODEL_CONFIGS
    cfg = dict(MODEL_CONFIGS[encoder])
    cfg.update(kw)
    return VideoDepthAnything(**cfg)
