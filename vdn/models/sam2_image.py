"""SAM2 promptable image segmentation model + predictor.

Re-design of the reference SAM2Base image path + SAM2ImagePredictor
(reference sam2/modeling/sam2_base.py:160-434, sam2/sam2_image_predictor.py):
Hiera trunk -> FPN neck (scalp 1) -> no-mem embedding on the stride-16
feature -> prompt encoder -> two-way mask decoder, with the sam2.1 flag set
(high-res skips, object scores, sigmoid IoU, dynamic multimask stability).

The reference builds this tree from hydra yaml configs
(sam2/build_sam.py:87-174); vdn uses plain module composition with the same
checkpoint key layout (image_encoder.trunk/neck, sam_prompt_encoder,
sam_mask_decoder, no_mem_embed, obj_ptr_proj, no_obj_ptr).

Video tracking (memory-conditioned track_step) lives in
vdn.models.sam2_video / vdn.pipelines.sam2_video.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vdn.nn import module as nn
from vdn.nn.hiera import Hiera, make_hiera
from vdn.nn.layers import Linear
from vdn.nn.sam2 import FpnNeck, MaskDecoder, PromptEncoder
from vdn.ops.resize import resize2d

Dtype = Any

NO_OBJ_SCORE = -1024.0


class Sam2ImageEncoder(nn.Module):
    """trunk + neck with scalp=1 (drop the stride-32 level)
    (reference backbones/image_encoder.py:14-42)."""
    trunk_variant: str = "hiera_base_plus"
    d_model: int = 256
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.trunk = make_hiera(self.trunk_variant, self.param_dtype)
        chans = tuple(reversed(
            [self.trunk.embed_dim * 2 ** i for i in range(4)]))
        self.neck = FpnNeck(d_model=self.d_model,
                            backbone_channel_list=chans,
                            fpn_top_down_levels=(2, 3),
                            fpn_interp_model="nearest",
                            param_dtype=self.param_dtype)

    def __call__(self, x: jnp.ndarray):
        feats, pos = self.neck(self.trunk(x))
        # scalp=1: discard the lowest-resolution level
        return feats[:-1], pos[:-1]


class Sam2ImageModel(nn.Module):
    trunk_variant: str = "hiera_base_plus"
    d_model: int = 256
    image_size: int = 1024
    backbone_stride: int = 16
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = True
    use_mlp_for_obj_ptr_proj: bool = False  # sam2.1 video config: True
    param_dtype: Dtype = jnp.float32
    # serving compute dtype (the reference benchmark runs bf16 autocast,
    # sam2/benchmark.py:20-24).  None keeps fp32 promotion semantics (the
    # parity default).  fp32 constants (sine PEs, prompt embeddings)
    # otherwise re-promote every downstream matmul: x fp32 @ w bf16 -> fp32
    # under jnp promotion, so a single leak keeps the whole graph fp32.
    compute_dtype: Optional[Dtype] = None

    def setup(self):
        pd = self.param_dtype
        d = self.d_model
        emb_size = self.image_size // self.backbone_stride
        self.image_encoder = Sam2ImageEncoder(self.trunk_variant, d, pd)
        self.sam_prompt_encoder = PromptEncoder(
            embed_dim=d, image_embedding_size=(emb_size, emb_size),
            input_image_size=(self.image_size, self.image_size),
            mask_in_chans=16, param_dtype=pd)
        self.sam_mask_decoder = MaskDecoder(
            transformer_dim=d, use_high_res_features=True,
            pred_obj_scores=self.pred_obj_scores,
            pred_obj_scores_mlp=self.pred_obj_scores_mlp,
            use_multimask_token_for_obj_ptr=True,
            iou_prediction_use_sigmoid=self.iou_prediction_use_sigmoid,
            dynamic_multimask_via_stability=True, param_dtype=pd)
        self.no_mem_embed = self.param("no_mem_embed",
                                       jax.nn.initializers.normal(0.02),
                                       (1, 1, d), pd)
        if self.use_mlp_for_obj_ptr_proj:
            from vdn.nn.sam2 import SamGenericMLP
            self.obj_ptr_proj = SamGenericMLP(d, d, 3, param_dtype=pd)
        else:
            self.obj_ptr_proj = Linear(d, param_dtype=pd)
        if self.pred_obj_scores:
            self.no_obj_ptr = self.param("no_obj_ptr",
                                         jax.nn.initializers.normal(0.02),
                                         (1, d), pd)

    def __call__(self, x: jnp.ndarray):
        """Full forward (encode + unprompted predict) — primarily so
        ``model.init`` creates every parameter; inference uses the
        encode_image/predict pair."""
        features = self.encode_image(x)
        return self.predict(features)

    def _cast(self, x):
        return x if self.compute_dtype is None else x.astype(
            self.compute_dtype)

    def encode_image(self, x: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """x [B, S, S, 3] (S = image_size, normalized) -> feature dict."""
        feats, _ = self.image_encoder(self._cast(x))
        s0, s1, s16 = feats
        # pre-project high-res skips (reference sam2_base.py:467-479)
        s0p, s1p = self.sam_mask_decoder.project_high_res_features(s0, s1)
        # directly_add_no_mem_embed (reference sam2_base.py:821-826 usage)
        b, h, w, c = s16.shape
        vision = (s16.reshape(b, h * w, c)
                  + self.no_mem_embed.astype(s16.dtype))
        return {"image_embed": vision.reshape(b, h, w, c),
                "high_res_0": s0p, "high_res_1": s1p}

    def predict(self, features: Dict[str, jnp.ndarray],
                point_coords: Optional[jnp.ndarray] = None,
                point_labels: Optional[jnp.ndarray] = None,
                boxes: Optional[jnp.ndarray] = None,
                mask_input: Optional[jnp.ndarray] = None,
                multimask_output: bool = True,
                apply_obj_gating: bool = True):
        """Mirrors reference _forward_sam_heads (sam2_base.py:256-408).

        ``apply_obj_gating=False`` reproduces the reference IMAGE predictor
        instead, which calls the decoder directly and never replaces masks
        with NO_OBJ_SCORE (sam2_image_predictor.py:430-466) — the video
        tracking path keeps the gating.

        Returns (low_res_multimasks [B,M,S/4,S/4], high_res_multimasks
        [B,M,S,S], ious [B,M], obj_ptr [B,C], object_score_logits [B,1])."""
        backbone = features["image_embed"]
        b = backbone.shape[0]
        if point_coords is None and boxes is None:
            point_coords = jnp.zeros((b, 1, 2), jnp.float32)
            point_labels = -jnp.ones((b, 1), jnp.float32)
        sparse, dense = self.sam_prompt_encoder(
            points=point_coords, labels=point_labels, boxes=boxes,
            masks=mask_input)
        image_pe = self.sam_prompt_encoder.get_dense_pe()
        low_res, ious, sam_tokens, obj_logits = self.sam_mask_decoder(
            self._cast(backbone), self._cast(image_pe),
            self._cast(sparse), self._cast(dense), multimask_output,
            high_res_features=(self._cast(features["high_res_0"]),
                               self._cast(features["high_res_1"])))
        is_obj = obj_logits > 0
        if self.pred_obj_scores and apply_obj_gating:
            low_res = jnp.where(is_obj[:, None, None], low_res,
                                NO_OBJ_SCORE)
        low_res = low_res.astype(jnp.float32)
        high_res = resize2d(low_res.transpose(0, 2, 3, 1),
                            (self.image_size, self.image_size),
                            "bilinear", align_corners=False
                            ).transpose(0, 3, 1, 2)
        sam_token = sam_tokens[:, 0]
        if multimask_output and sam_tokens.shape[1] > 1:
            best = jnp.argmax(ious, axis=-1)
            sam_token = sam_tokens[jnp.arange(b), best]
        obj_ptr = self.obj_ptr_proj(sam_token)
        if self.pred_obj_scores:
            lam = is_obj.astype(obj_ptr.dtype)
            if self.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1 - lam) * self.no_obj_ptr.astype(
                obj_ptr.dtype)
        return low_res, high_res, ious, obj_ptr, obj_logits


class Sam2ImagePredictor:
    """Host wrapper with the reference predictor ergonomics
    (sam2/sam2_image_predictor.py): set_image -> predict(points/box)."""

    IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, model: Sam2ImageModel, params,
                 mask_threshold: float = 0.0):
        self.model = model
        self.params = params
        self.mask_threshold = mask_threshold
        self._features = None
        self._orig_hw = None
        self._encode = jax.jit(
            lambda p, x: model.apply(p, x, method=model.encode_image))
        self._predict = jax.jit(
            lambda p, f, pc, pl, mm: model.apply(
                p, f, point_coords=pc, point_labels=pl,
                multimask_output=mm, apply_obj_gating=False,
                method=model.predict),
            static_argnums=(4,))
        # batched-prompt decode over ONE cached image: features broadcast
        # to the prompt batch on device (the reference decoder's
        # repeat_interleave, sam/mask_decoder.py) — the AMG path decodes
        # 64 points per dispatch instead of one
        self._predict_batch = jax.jit(
            lambda p, f, pc, pl, mm: model.apply(
                p,
                {k: jnp.broadcast_to(v, (pc.shape[0],) + v.shape[1:])
                 for k, v in f.items()},
                point_coords=pc, point_labels=pl,
                multimask_output=mm, apply_obj_gating=False,
                method=model.predict),
            static_argnums=(4,))

    def set_image(self, image_rgb: np.ndarray):
        """uint8/float RGB HWC -> cached features (square 1024 resize)."""
        import cv2
        self._orig_hw = image_rgb.shape[:2]
        s = self.model.image_size
        img = cv2.resize(image_rgb.astype(np.float32) / 255.0, (s, s),
                         interpolation=cv2.INTER_LINEAR)
        img = (img - self.IMAGENET_MEAN) / self.IMAGENET_STD
        self._features = self._encode(self.params, img[None])

    def predict(self, point_coords=None, point_labels=None,
                box=None, multimask_output: bool = True,
                return_logits: bool = False):
        """point_coords / box in original-image pixels ->
        (masks [M, H, W] bool — or float logits with ``return_logits`` —
        ious [M], low_res_logits).  A box prompt is encoded as two labeled
        corner points (labels 2/3), matching the reference predictor's box
        path."""
        assert self._features is not None, "call set_image first"
        h, w = self._orig_hw
        s = self.model.image_size
        scale = np.array([s / w, s / h], np.float32)
        pts, lbls = [], []
        if point_coords is not None:
            pts.append(np.asarray(point_coords, np.float32) * scale)
            lbls.append(np.asarray(point_labels, np.float32))
        if box is not None:
            corners = np.asarray(box, np.float32).reshape(2, 2) * scale
            pts.append(corners)
            lbls.append(np.asarray([2.0, 3.0], np.float32))
        pc = np.concatenate(pts, axis=0)[None]
        pl = np.concatenate(lbls, axis=0)[None]
        low, high, ious, _, _ = self._predict(self.params, self._features,
                                              pc, pl, multimask_output)
        masks = resize2d(np.asarray(high).transpose(0, 2, 3, 1), (h, w),
                         "bilinear", align_corners=False)
        masks = np.asarray(masks)[0].transpose(2, 0, 1)
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks, np.asarray(ious)[0], np.asarray(low)[0]

    def predict_batch(self, point_coords, point_labels=None,
                      multimask_output: bool = True,
                      return_logits: bool = False):
        """Batched single-point prompts over the cached image (the AMG
        unit; reference automatic_mask_generator.py _process_batch runs
        the decoder over the whole point batch at once).

        point_coords [P, 2] in original-image pixels ->
        (masks [P, M, H, W], ious [P, M], low_res [P, M, h, w])."""
        assert self._features is not None, "call set_image first"
        h, w = self._orig_hw
        s = self.model.image_size
        scale = np.array([s / w, s / h], np.float32)
        pc = (np.asarray(point_coords, np.float32) * scale)[:, None, :]
        if point_labels is None:
            pl = np.ones((pc.shape[0], 1), np.float32)
        else:
            pl = np.asarray(point_labels, np.float32).reshape(
                pc.shape[0], 1)
        low, high, ious, _, _ = self._predict_batch(
            self.params, self._features, pc, pl, multimask_output)
        masks = resize2d(np.asarray(high).transpose(0, 2, 3, 1), (h, w),
                         "bilinear", align_corners=False)
        masks = np.asarray(masks).transpose(0, 3, 1, 2)
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks, np.asarray(ious), np.asarray(low)
