"""SAM2 video tracking: memory-conditioned promptable segmentation.

Re-design of the reference SAM2Base tracking path
(reference sam2/modeling/sam2_base.py:497-910 and
sam2/sam2_video_predictor.py), sam2.1 video flag set: 7 mask-memory slots,
64-dim memory features, object pointers (4 x 64-dim tokens each) with
signed sine temporal encodings, memory attention with relu FFN and
pos-enc'd keys.

NOTE: the reference repo as shipped cannot run this path — the fork renamed
the memory encoder's output keys to {memory_feature, memory_pos_enc}
(memory_encoder.py:181) while sam2_base.py:695-697 still reads
{vision_features, vision_pos_enc}; vdn uses one consistent contract.

Host-side orchestration (per-frame memory selection, the python dicts of
the reference) lives in Sam2VideoPredictor; the per-frame compute is the
jit-able methods on Sam2VideoModel.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vdn.models.sam2_image import Sam2ImageModel
from vdn.nn import module as nn
from vdn.nn.layers import Conv2d, LayerNorm, Linear
from vdn.nn.memory import Fuser, MemoryAttention
from vdn.ops.sine_pe import sine_position_embedding_2d

Dtype = Any


def get_1d_sine_pe(pos: jnp.ndarray, dim: int,
                   temperature: float = 10000.0) -> jnp.ndarray:
    """(reference sam2_utils.py:64-74)"""
    pe_dim = dim // 2
    dim_t = jnp.arange(pe_dim, dtype=jnp.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    pos_embed = pos[..., None] / dim_t
    return jnp.concatenate([jnp.sin(pos_embed), jnp.cos(pos_embed)],
                           axis=-1)


class Sam2MaskDownSampler(nn.Module):
    """Single 4-stage stride-16 mask pyramid (reference
    memory_encoder.py:17-58 with total_stride=16): channels 1->4->16->64->
    256 then a 1x1 projection; Sequential indices 0..12 mirror torch keys."""
    embed_dim: int = 256
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        pd = self.param_dtype
        ch = 1
        idx = 0
        for _ in range(4):
            out_ch = ch * 4
            x = Conv2d(out_ch, (3, 3), stride=(2, 2), padding=1,
                       param_dtype=pd, name=f"encoder_{idx}")(x)
            x = LayerNorm(epsilon=1e-6, param_dtype=pd,
                          name=f"encoder_{idx + 1}")(x)
            x = jax.nn.gelu(x, approximate=False)
            ch = out_ch
            idx += 3
        return Conv2d(self.embed_dim, (1, 1), padding=0, param_dtype=pd,
                      name=f"encoder_{idx}")(x)


class Sam2MemoryEncoder(nn.Module):
    """(pix_feat [B,h,w,256], high-res mask) -> 64-dim memory feature + pos
    (reference memory_encoder.py:137-181, sam2.1 config)."""
    in_dim: int = 256
    out_dim: int = 64
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, pix_feat: jnp.ndarray, masks: jnp.ndarray,
                 skip_mask_sigmoid: bool = False):
        pd = self.param_dtype
        if not skip_mask_sigmoid:
            masks = jax.nn.sigmoid(masks)
        masks = Sam2MaskDownSampler(self.in_dim, pd,
                                    name="mask_downsampler")(masks)
        x = Conv2d(self.in_dim, (1, 1), padding=0, param_dtype=pd,
                   name="pix_feat_proj")(pix_feat)
        x = x + masks
        x = Fuser(self.in_dim, 2, pd, name="fuser")(x)
        x = Conv2d(self.out_dim, (1, 1), padding=0, param_dtype=pd,
                   name="out_proj")(x)
        b, h, w, c = x.shape
        pos = jnp.asarray(sine_position_embedding_2d(h, w, self.out_dim))
        pos = jnp.broadcast_to(pos[None], x.shape).astype(x.dtype)
        return x, pos


class Sam2VideoModel(Sam2ImageModel):
    """Sam2ImageModel + memory machinery (sam2.1 video config)."""
    num_maskmem: int = 7
    mem_dim: int = 64
    max_obj_ptrs_in_encoder: int = 16
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    use_mlp_for_obj_ptr_proj: bool = True

    def setup(self):
        super().setup()
        pd = self.param_dtype
        d = self.d_model
        self.memory_attention = MemoryAttention(
            d, num_heads=1, num_layers=4, param_dtype=pd,
            dim_feedforward=2048, activation="relu",
            pos_enc_at_cross_attn_queries=False)
        # pos_enc_at_cross_attn_keys=True flows via memory_pos below
        self.memory_encoder = Sam2MemoryEncoder(d, self.mem_dim, pd)
        self.maskmem_tpos_enc = self.param(
            "maskmem_tpos_enc", jax.nn.initializers.normal(0.02),
            (self.num_maskmem, 1, 1, self.mem_dim), pd)
        self.no_mem_pos_enc = self.param(
            "no_mem_pos_enc", jax.nn.initializers.normal(0.02), (1, 1, d), pd)
        self.obj_ptr_tpos_proj = Linear(self.mem_dim, param_dtype=pd)
        self.no_obj_embed_spatial = self.param(
            "no_obj_embed_spatial", jax.nn.initializers.normal(0.02),
            (1, self.mem_dim), pd)
        # 4x4/4 conv shrinking a full-res input mask to the SAM prompt
        # resolution (reference sam2_base.py:110 self.mask_downsample)
        self.mask_downsample = Conv2d(1, (4, 4), stride=(4, 4),
                                      param_dtype=pd)

    def __call__(self, x: jnp.ndarray):
        """Full forward touching every submodule (so ``model.init``
        creates all params): encode, memory-write, memory-read, predict."""
        feats = self.encode_image_raw(x)
        out = self.predict(self.add_no_mem(feats))
        _, high, _, obj_ptr, obj_logits = out
        # touch the mask-prompt path so init creates mask_downsample params
        b, hh, ww, _ = x.shape
        self.use_mask_as_output(feats, jnp.zeros((b, 1, hh, ww),
                                                 jnp.float32))
        mem_feat, mem_pos = self.encode_memory(feats, high[:, :1],
                                               obj_logits)
        b, h, w, c = mem_feat.shape
        memory = mem_feat.reshape(b, h * w, c)
        memory_pos = self.maskmem_pos_with_tpos(mem_pos, 0).reshape(
            b, h * w, c)
        tokens, tok_pos = self.obj_ptr_tokens(
            obj_ptr, jnp.zeros((obj_ptr.shape[0],), jnp.float32))
        memory = jnp.concatenate([memory, tokens[None]], axis=1)
        memory_pos = jnp.concatenate([memory_pos, tok_pos[None]], axis=1)
        conditioned = self.condition_features(feats, memory, memory_pos,
                                              tokens.shape[0])
        return self.predict(conditioned)

    def use_mask_as_output(self, features: Dict[str, jnp.ndarray],
                           mask_inputs: jnp.ndarray):
        """Directly turn a binary input mask into output logits without the
        SAM decoder (reference sam2_base.py:415-465 _use_mask_as_output);
        the object pointer still comes from the SAM heads fed the
        mask-downsampled prompt.

        mask_inputs: [B, 1, S, S] float 0/1.  Returns the predict() tuple
        (low_res, high_res, ious, obj_ptr, object_score_logits)."""
        from vdn.ops.resize import resize2d

        out_scale, out_bias = 20.0, -10.0
        mask = mask_inputs.astype(jnp.float32)
        high_res = mask * out_scale + out_bias
        s = high_res.shape[-1]
        low_res = resize2d(high_res.transpose(0, 2, 3, 1),
                           (s // 4, s // 4), "bilinear_aa", False
                           ).transpose(0, 3, 1, 2)
        ious = jnp.ones((mask.shape[0], 1), jnp.float32)
        mask_ds = self.mask_downsample(mask.transpose(0, 2, 3, 1))
        _, _, _, obj_ptr, _ = self.predict(features, mask_input=mask_ds,
                                           multimask_output=False)
        is_obj = jnp.any(mask.reshape(mask.shape[0], -1) > 0.0, axis=1)
        lam = is_obj.astype(jnp.float32)[:, None]
        object_score_logits = out_scale * lam + out_bias
        if self.pred_obj_scores:
            if self.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1 - lam) * self.no_obj_ptr.astype(
                obj_ptr.dtype)
        return low_res, high_res, ious, obj_ptr, object_score_logits

    # ---- memory-conditioned features ---------------------------------
    def condition_features(self, features: Dict[str, jnp.ndarray],
                           memory: jnp.ndarray, memory_pos: jnp.ndarray,
                           num_obj_ptr_tokens: int
                           ) -> Dict[str, jnp.ndarray]:
        """Cross-attend the stride-16 tokens to assembled memory
        (reference _prepare_memory_conditioned_features:497-678; the
        memory/memory_pos tensors come pre-assembled from the host
        predictor).  NOTE: encode_image adds no_mem_embed for the image
        path — pass raw s16 features here via encode_image_raw."""
        s16 = features["image_embed"]
        b, h, w, c = s16.shape
        tokens = s16.reshape(b, h * w, c)
        pos = jnp.asarray(sine_position_embedding_2d(h, w, c))
        pos = jnp.broadcast_to(pos[None].reshape(1, h * w, c),
                               tokens.shape).astype(tokens.dtype)
        out = self.memory_attention(
            tokens, self._cast(memory), pos, (h, w),
            memory_pos=self._cast(memory_pos),
            num_k_exclude_rope=num_obj_ptr_tokens)
        feats = dict(features)
        feats["image_embed"] = out.reshape(b, h, w, c)
        return feats

    def encode_image_raw(self, x: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """Like encode_image but WITHOUT the no-mem embedding (tracking
        frames get memory instead)."""
        feats, _ = self.image_encoder(self._cast(x))
        s0, s1, s16 = feats
        s0p, s1p = self.sam_mask_decoder.project_high_res_features(s0, s1)
        return {"image_embed": s16, "high_res_0": s0p, "high_res_1": s1p}

    def add_no_mem(self, features: Dict[str, jnp.ndarray]):
        s16 = features["image_embed"]
        b, h, w, c = s16.shape
        vision = s16.reshape(b, h * w, c) + self.no_mem_embed.astype(
            s16.dtype)
        out = dict(features)
        out["image_embed"] = vision.reshape(b, h, w, c)
        return out

    # ---- memory write -------------------------------------------------
    def encode_memory(self, features: Dict[str, jnp.ndarray],
                      high_res_masks: jnp.ndarray,
                      object_score_logits: jnp.ndarray):
        """(reference _encode_new_memory:679-728): scaled-sigmoid mask +
        pixel features -> (maskmem_feat [B,h,w,64], maskmem_pos).
        high_res_masks: [B, 1, S, S] (the predict() output convention)."""
        pix_feat = features["image_embed"]
        high_res_masks = high_res_masks.transpose(0, 2, 3, 1)  # -> NHWC
        mask = jax.nn.sigmoid(high_res_masks)
        mask = mask * self.sigmoid_scale_for_mem_enc \
            + self.sigmoid_bias_for_mem_enc
        feat, pos = self.memory_encoder(pix_feat, self._cast(mask),
                                        skip_mask_sigmoid=True)
        is_obj = (object_score_logits > 0).astype(feat.dtype)
        feat = feat + (1.0 - is_obj[..., None, None]) \
            * self.no_obj_embed_spatial.reshape(1, 1, 1, -1).astype(
                feat.dtype)
        return feat, pos

    # ---- temporal encodings (host assembles, model supplies tables) ---
    def maskmem_pos_with_tpos(self, pos: jnp.ndarray, t_pos: int
                              ) -> jnp.ndarray:
        """Add the per-slot temporal embedding (reference :544-556):
        slot index num_maskmem - t_pos - 1."""
        return pos + self.maskmem_tpos_enc[self.num_maskmem - t_pos - 1]

    def obj_ptr_tokens(self, obj_ptrs: jnp.ndarray, t_diffs: jnp.ndarray
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """[P, C] pointers + signed frame offsets -> (tokens [P*4, 64],
        pos [P*4, 64]) (reference :618-640; proj_tpos_enc_in_obj_ptrs and
        use_signed_tpos flags from the 2.1 config)."""
        c = self.d_model
        split = c // self.mem_dim
        t_max = self.max_obj_ptrs_in_encoder - 1
        pos = get_1d_sine_pe(t_diffs / t_max, dim=c)
        pos = self.obj_ptr_tpos_proj(pos)  # [P, mem_dim]
        tokens = obj_ptrs.reshape(-1, split, self.mem_dim)
        tokens = tokens.reshape(-1, self.mem_dim)  # p0t0..p0t3, p1t0..
        pos = jnp.repeat(pos, split, axis=0)
        return tokens, pos
