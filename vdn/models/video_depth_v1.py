"""v1 research model: dual-Hiera encoders + sangyu spatiotemporal head.

Re-design of the reference VideoDepthEstimationModel
(reference models/video_depth_model.py:18-127): one Hiera encoder on RGB,
one on [depth, nx, ny], per-level feature sums, the sangyu head decoding to
(depth, dx, dy), and a normal map rebuilt as [-dx, -dy, 1].

Encoder families: hub-style names ending in ``_224`` (the reference's
own ``model_name`` values, e.g. ``hiera_base_224``) select the plain
MAE Hiera (`vdn/nn/hiera_mae.py` — architecture-exact vs the torch-hub
model the reference loads, so reference v1 checkpoints convert); bare
names (``hiera_base``) keep the SAM2 hieradet variant used for the
in-repo head-to-toe parity tests (tests/test_video_heads_parity).

The reference reinterprets NHWC encoder features as NCHW via ``.view``
(video_depth_model.py:96-97), scrambling the layout before the head.  Its
checkpoints are trained WITH that relabeling, so ``scrambled_layout=True``
(default) replicates it bit-for-bit for checkpoint compatibility;
``scrambled_layout=False`` gives the fixed, consistent-NHWC wiring.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.hiera import make_hiera
from vdn.nn.video_heads import VideoDepthHeadSangyu
from vdn.ops.normals import normal_vector
from vdn.ops.resize import resize2d

Dtype = Any


class VideoDepthEstimationModel(nn.Module):
    sequence_length: int = 8
    attention_feature_levels: Sequence[int] = (2, 3)
    encoder: str = "hiera_base"
    use_residual: bool = False
    use_final_relu: bool = False
    use_depth_feature: bool = True
    use_rgb_feature: bool = True
    scrambled_layout: bool = True
    param_dtype: Dtype = jnp.float32

    def setup(self):
        from vdn.nn.hiera import HIERA_CONFIGS
        from vdn.nn.hiera_mae import HIERA_MAE_CONFIGS, make_hiera_mae
        if self.encoder in HIERA_MAE_CONFIGS:  # hub-MAE family
            make = lambda name: make_hiera_mae(  # noqa: E731
                self.encoder, self.param_dtype, name=name)
            dim0 = HIERA_MAE_CONFIGS[self.encoder]["embed_dim"]
        else:  # SAM2 hieradet family
            make = lambda name: make_hiera(  # noqa: E731
                self.encoder, self.param_dtype, name=name)
            dim0 = HIERA_CONFIGS[self.encoder]["embed_dim"]
        self.img_encoder = make("img_encoder")
        self.depth_encoder = make("encoder")
        ch = tuple(dim0 * 2 ** i for i in range(4))
        self.head = VideoDepthHeadSangyu(
            sequence_length=self.sequence_length,
            attention_feature_levels=tuple(self.attention_feature_levels),
            feature_channels=ch, param_dtype=self.param_dtype)

    def __call__(self, depth: jnp.ndarray, img: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """depth [B, S, H, W], img [B, S, H, W, 3] ->
        (depth [B, S, H, W], normal [B, S, H, W, 3])."""
        b, s, h, w = depth.shape
        normals = normal_vector(depth)
        depth_img = jnp.concatenate([depth[..., None], normals[..., :2]],
                                    axis=-1)

        def run(enc, inp):
            out = enc(inp)
            # MAE family returns (pooled, intermediates); the reference
            # discards the classifier output (hiera_image_encoder.py:58)
            return out[1] if isinstance(out, tuple) else out

        feats = []
        if self.use_depth_feature:
            feats.append(run(self.depth_encoder,
                             depth_img.reshape(b * s, h, w, 3)))
        if self.use_rgb_feature:
            feats.append(run(self.img_encoder,
                             img.reshape(b * s, h, w, 3)))
        if len(feats) == 2:
            levels = [d + r for d, r in zip(*feats)]
        else:
            levels = feats[0]
        if self.scrambled_layout:
            # replicate the reference's .view(B, S, D, H, W) of NHWC memory
            # (a pure reinterpretation, not a transpose), then relabel to
            # the NHWC convention our head expects
            levels = [
                f.reshape(b, s, f.shape[-1], f.shape[1], f.shape[2])
                .transpose(0, 1, 3, 4, 2) for f in levels]
        else:
            levels = [f.reshape(b, s, *f.shape[1:]) for f in levels]

        out = self.head(levels)  # [B, S, h', w', 3]
        if out.shape[2:4] != (h, w):
            out = resize2d(out.reshape(b * s, *out.shape[2:]), (h, w),
                           "bilinear", align_corners=True)
            out = out.reshape(b, s, h, w, 3)

        out_depth = out[..., 0]
        if self.use_residual:
            out_depth = out_depth + depth
        dx, dy = out[..., 1], out[..., 2]
        normal = jnp.stack([-dx, -dy, jnp.ones_like(dx)], axis=-1)
        if self.use_final_relu:
            out_depth = jax.nn.relu(out_depth)
        return out_depth, normal
