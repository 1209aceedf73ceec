"""SAM2 promptable-segmentation components.

Re-design of the vendored SAM2 modeling tree the reference ships
(reference sam2/modeling/): FPN image encoder neck
(backbones/image_encoder.py:44-134), prompt encoder
(sam/prompt_encoder.py:16-202), two-way transformer
(sam/transformer.py:1-188) and mask decoder (sam/mask_decoder.py:1-295).
RoPE/memory attention and the memory encoder live in vdn.nn.memory (they
are what the fork's depth models actually graft in); the Hiera trunk is
vdn.nn.hiera.  NHWC feature maps, tokens [B, N, C].
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vdn.nn import module as nn
from vdn.nn.layers import Conv2d, ConvTranspose2d, LayerNorm, Linear
from vdn.ops.attention import dot_product_attention
from vdn.ops.resize import interpolate_like_torch
from vdn.ops.sine_pe import sine_position_embedding_2d

Dtype = Any


class SamGenericMLP(nn.Module):
    """sam2_utils.MLP: num_layers Linears with relu between, optional
    sigmoid output; submodules layers_0..layers_{n-1}."""
    hidden_dim: int
    output_dim: int
    num_layers: int
    sigmoid_output: bool = False
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        for i in range(self.num_layers):
            out = (self.output_dim if i == self.num_layers - 1
                   else self.hidden_dim)
            x = Linear(out, param_dtype=self.param_dtype,
                       name=f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = jax.nn.relu(x)
        if self.sigmoid_output:
            x = jax.nn.sigmoid(x)
        return x


class SamAttention(nn.Module):
    """SAM attention with optional internal downsampling
    (reference sam/transformer.py:189-248)."""
    embedding_dim: int
    num_heads: int
    downsample_rate: int = 1
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, q, k, v):
        c = self.embedding_dim // self.downsample_rate
        h = self.num_heads
        pd = self.param_dtype
        q = Linear(c, param_dtype=pd, name="q_proj")(q)
        k = Linear(c, param_dtype=pd, name="k_proj")(k)
        v = Linear(c, param_dtype=pd, name="v_proj")(v)
        b, nq, _ = q.shape
        nk = k.shape[1]
        out = dot_product_attention(q.reshape(b, nq, h, c // h),
                                    k.reshape(b, nk, h, c // h),
                                    v.reshape(b, nk, h, c // h))
        out = out.reshape(b, nq, c)
        return Linear(self.embedding_dim, param_dtype=pd,
                      name="out_proj")(out)


class TwoWayAttentionBlock(nn.Module):
    """(reference sam/transformer.py:110-188)"""
    embedding_dim: int
    num_heads: int
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    skip_first_layer_pe: bool = False
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, queries, keys, query_pe, key_pe):
        pd = self.param_dtype
        d = self.embedding_dim
        if self.skip_first_layer_pe:
            queries = SamAttention(d, self.num_heads, 1, pd,
                                   name="self_attn")(queries, queries,
                                                     queries)
        else:
            q = queries + query_pe
            attn = SamAttention(d, self.num_heads, 1, pd,
                                name="self_attn")(q, q, queries)
            queries = queries + attn
        queries = LayerNorm(epsilon=1e-5, param_dtype=pd,
                            name="norm1")(queries)

        q = queries + query_pe
        k = keys + key_pe
        attn = SamAttention(d, self.num_heads,
                            self.attention_downsample_rate, pd,
                            name="cross_attn_token_to_image")(q, k, keys)
        queries = queries + attn
        queries = LayerNorm(epsilon=1e-5, param_dtype=pd,
                            name="norm2")(queries)

        mlp_out = SamGenericMLP(self.mlp_dim, d, 2, param_dtype=pd,
                                name="mlp")(queries)
        queries = queries + mlp_out
        queries = LayerNorm(epsilon=1e-5, param_dtype=pd,
                            name="norm3")(queries)

        q = queries + query_pe
        k = keys + key_pe
        attn = SamAttention(d, self.num_heads,
                            self.attention_downsample_rate, pd,
                            name="cross_attn_image_to_token")(k, q, queries)
        keys = keys + attn
        keys = LayerNorm(epsilon=1e-5, param_dtype=pd, name="norm4")(keys)
        return queries, keys


class TwoWayTransformer(nn.Module):
    """(reference sam/transformer.py:1-108)"""
    depth: int
    embedding_dim: int
    num_heads: int
    mlp_dim: int
    attention_downsample_rate: int = 2
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, image_embedding, image_pe, point_embedding):
        """image_embedding/image_pe [B, H, W, C]; point_embedding [B, N, C]
        -> (queries [B, N, C], keys [B, H*W, C])."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = TwoWayAttentionBlock(
                self.embedding_dim, self.num_heads, self.mlp_dim,
                self.attention_downsample_rate,
                skip_first_layer_pe=(i == 0), param_dtype=self.param_dtype,
                name=f"layers_{i}")(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        attn = SamAttention(self.embedding_dim, self.num_heads,
                            self.attention_downsample_rate,
                            self.param_dtype,
                            name="final_attn_token_to_image")(q, k, keys)
        queries = queries + attn
        queries = LayerNorm(epsilon=1e-5, param_dtype=self.param_dtype,
                            name="norm_final_attn")(queries)
        return queries, keys


class PromptEncoder(nn.Module):
    """(reference sam/prompt_encoder.py:16-202).  Point labels: -1 pad,
    0 negative, 1 positive, 2/3 box corners."""
    embed_dim: int = 256
    image_embedding_size: Tuple[int, int] = (64, 64)
    input_image_size: Tuple[int, int] = (1024, 1024)
    mask_in_chans: int = 16
    param_dtype: Dtype = jnp.float32

    def setup(self):
        pd = self.param_dtype
        c = self.embed_dim
        self.pe_layer = _RandomPositionEncoding(c // 2, pd)
        self.point_embeddings = [
            nn.Embed(1, c, param_dtype=pd, name=f"point_embeddings_{i}")
            for i in range(4)]
        self.not_a_point_embed = nn.Embed(1, c, param_dtype=pd)
        self.no_mask_embed = nn.Embed(1, c, param_dtype=pd)
        mc = self.mask_in_chans
        self.mask_downscaling_0 = Conv2d(mc // 4, (2, 2), stride=(2, 2),
                                         padding=0, param_dtype=pd)
        self.mask_downscaling_1 = LayerNorm(epsilon=1e-6, param_dtype=pd)
        self.mask_downscaling_3 = Conv2d(mc, (2, 2), stride=(2, 2),
                                         padding=0, param_dtype=pd)
        self.mask_downscaling_4 = LayerNorm(epsilon=1e-6, param_dtype=pd)
        self.mask_downscaling_6 = Conv2d(c, (1, 1), padding=0,
                                         param_dtype=pd)

    def _pe_encoding(self, coords: jnp.ndarray) -> jnp.ndarray:
        return self.pe_layer.encode(coords)

    def get_dense_pe(self) -> jnp.ndarray:
        """[1, H, W, C] grid positional encoding."""
        h, w = self.image_embedding_size
        y = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
        x = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
        grid = jnp.stack(jnp.meshgrid(x, y, indexing="xy"), axis=-1)
        return self._pe_encoding(grid)[None]

    def embed_points(self, points: jnp.ndarray, labels: jnp.ndarray,
                     pad: bool = True) -> jnp.ndarray:
        """points [B, N, 2] (pixel coords), labels [B, N] -> [B, N(+1), C]."""
        points = points + 0.5
        if pad:
            points = jnp.concatenate(
                [points, jnp.zeros((points.shape[0], 1, 2))], axis=1)
            labels = jnp.concatenate(
                [labels, -jnp.ones((labels.shape[0], 1))], axis=1)
        coords = points / jnp.asarray(
            [self.input_image_size[1], self.input_image_size[0]],
            jnp.float32)
        emb = self._pe_encoding(coords.astype(jnp.float32))
        labels = labels[..., None]
        emb = jnp.where(labels == -1,
                        self.not_a_point_embed.embedding.astype(emb.dtype),
                        emb)
        for i in range(4):
            emb = jnp.where(
                labels == i,
                emb + self.point_embeddings[i].embedding.astype(emb.dtype),
                emb)
        return emb

    def embed_boxes(self, boxes: jnp.ndarray) -> jnp.ndarray:
        """boxes [B, 4] xyxy -> [B, 2, C]."""
        boxes = boxes + 0.5
        coords = boxes.reshape(-1, 2, 2) / jnp.asarray(
            [self.input_image_size[1], self.input_image_size[0]],
            jnp.float32)
        emb = self._pe_encoding(coords.astype(jnp.float32))
        emb = emb.at[:, 0].add(self.point_embeddings[2].embedding[0])
        emb = emb.at[:, 1].add(self.point_embeddings[3].embedding[0])
        return emb

    def embed_masks(self, masks: jnp.ndarray) -> jnp.ndarray:
        """masks [B, 4H, 4W, 1] -> dense embedding [B, H, W, C]."""
        x = self.mask_downscaling_0(masks)
        x = jax.nn.gelu(self.mask_downscaling_1(x), approximate=False)
        x = self.mask_downscaling_3(x)
        x = jax.nn.gelu(self.mask_downscaling_4(x), approximate=False)
        return self.mask_downscaling_6(x)

    def no_mask_dense(self, batch: int) -> jnp.ndarray:
        h, w = self.image_embedding_size
        return jnp.broadcast_to(
            self.no_mask_embed.embedding.reshape(1, 1, 1, -1),
            (batch, h, w, self.embed_dim))

    def __call__(self, points=None, labels=None, boxes=None, masks=None):
        """-> (sparse [B, N, C], dense [B, H, W, C])."""
        batch = 1
        sparse_list = []
        if points is not None:
            batch = points.shape[0]
            sparse_list.append(self.embed_points(points, labels,
                                                 pad=(boxes is None)))
        if boxes is not None:
            batch = boxes.shape[0]
            sparse_list.append(self.embed_boxes(boxes))
        sparse = (jnp.concatenate(sparse_list, axis=1) if sparse_list
                  else jnp.zeros((batch, 0, self.embed_dim)))
        if masks is not None:
            dense = self.embed_masks(masks)
        else:
            dense = self.no_mask_dense(batch)
        return sparse, dense


class MaskDecoder(nn.Module):
    """(reference sam/mask_decoder.py:1-295), sam2.1 config: high-res skip
    features, object-score prediction, dynamic multimask stability."""
    transformer_dim: int = 256
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    use_high_res_features: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = False
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98
    two_way_depth: int = 2
    two_way_heads: int = 8
    two_way_mlp_dim: int = 2048
    param_dtype: Dtype = jnp.float32

    def setup(self):
        pd = self.param_dtype
        d = self.transformer_dim
        self.num_mask_tokens = self.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(
            self.two_way_depth, d, self.two_way_heads, self.two_way_mlp_dim,
            param_dtype=pd)
        self.iou_token = nn.Embed(1, d, param_dtype=pd)
        self.mask_tokens = nn.Embed(self.num_mask_tokens, d, param_dtype=pd)
        if self.pred_obj_scores:
            self.obj_score_token = nn.Embed(1, d, param_dtype=pd)
            if self.pred_obj_scores_mlp:
                self.pred_obj_score_head = SamGenericMLP(d, 1, 3,
                                                         param_dtype=pd)
            else:
                self.pred_obj_score_head = Linear(1, param_dtype=pd)
        self.output_upscaling_0 = ConvTranspose2d(d // 4, (2, 2), (2, 2),
                                                  param_dtype=pd)
        self.output_upscaling_1 = LayerNorm(epsilon=1e-6, param_dtype=pd)
        self.output_upscaling_3 = ConvTranspose2d(d // 8, (2, 2), (2, 2),
                                                  param_dtype=pd)
        if self.use_high_res_features:
            self.conv_s0 = Conv2d(d // 8, (1, 1), padding=0, param_dtype=pd)
            self.conv_s1 = Conv2d(d // 4, (1, 1), padding=0, param_dtype=pd)
        self.output_hypernetworks_mlps = [
            SamGenericMLP(d, d // 8, 3, param_dtype=pd,
                          name=f"output_hypernetworks_mlps_{i}")
            for i in range(self.num_mask_tokens)]
        self.iou_prediction_head = SamGenericMLP(
            self.iou_head_hidden_dim, self.num_mask_tokens,
            self.iou_head_depth,
            sigmoid_output=self.iou_prediction_use_sigmoid, param_dtype=pd)

    def __call__(self, image_embeddings, image_pe, sparse_prompts,
                 dense_prompts, multimask_output: bool,
                 high_res_features=None, deterministic: bool = True):
        """image_embeddings/dense [B, H, W, C]; image_pe [1, H, W, C];
        sparse [B, N, C] -> (masks [B, M, 4H, 4W], iou [B, M],
        sam_tokens [B, M', C], object_score_logits [B, 1])."""
        d = self.transformer_dim
        b = sparse_prompts.shape[0]
        s = 0
        toks = [self.iou_token.embedding, self.mask_tokens.embedding]
        if self.pred_obj_scores:
            toks = [self.obj_score_token.embedding] + toks
            s = 1
        output_tokens = jnp.concatenate(toks, axis=0)
        tokens = jnp.concatenate(
            [jnp.broadcast_to(output_tokens[None],
                              (b, *output_tokens.shape)),
             sparse_prompts], axis=1)

        src = image_embeddings + dense_prompts
        pos = jnp.broadcast_to(image_pe, src.shape)
        hs, keys = self.transformer(src, pos, tokens)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens]

        bh, hh, wh, _ = src.shape
        up = keys.reshape(bh, hh, wh, d)
        if self.use_high_res_features:
            # features arrive pre-projected by project_high_res_features
            # (the reference applies conv_s0/s1 in SAM2Base, outside the
            # decoder forward — mask_decoder.py:221-226)
            feat_s0, feat_s1 = high_res_features
            x = self.output_upscaling_0(up) + feat_s1
            x = jax.nn.gelu(self.output_upscaling_1(x), approximate=False)
            x = self.output_upscaling_3(x) + feat_s0
            upscaled = jax.nn.gelu(x, approximate=False)
        else:
            x = self.output_upscaling_0(up)
            x = jax.nn.gelu(self.output_upscaling_1(x), approximate=False)
            upscaled = jax.nn.gelu(self.output_upscaling_3(x),
                                   approximate=False)

        hyper = jnp.stack(
            [mlp(mask_tokens_out[:, i])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            axis=1)  # [B, M, d/8]
        bu, hu, wu, cu = upscaled.shape
        masks = jnp.einsum("bmc,bhwc->bmhw", hyper, upscaled)
        iou_pred = self.iou_prediction_head(iou_token_out)
        if self.pred_obj_scores:
            object_score_logits = self.pred_obj_score_head(hs[:, 0])
        else:
            object_score_logits = 10.0 * jnp.ones((b, 1), masks.dtype)

        if multimask_output:
            masks_out = masks[:, 1:]
            iou_out = iou_pred[:, 1:]
            sam_tokens = (mask_tokens_out[:, 1:]
                          if self.use_multimask_token_for_obj_ptr
                          else mask_tokens_out[:, :1])
        elif self.dynamic_multimask_via_stability:
            masks_out, iou_out = self._dynamic_multimask(masks, iou_pred)
            sam_tokens = mask_tokens_out[:, :1]
        else:
            masks_out = masks[:, :1]
            iou_out = iou_pred[:, :1]
            sam_tokens = mask_tokens_out[:, :1]
        return masks_out, iou_out, sam_tokens, object_score_logits

    def project_high_res_features(self, fpn_s0, fpn_s1):
        """conv_s0/conv_s1 on the stride-4/8 FPN maps — the reference runs
        these in SAM2Base before calling the decoder."""
        return self.conv_s0(fpn_s0), self.conv_s1(fpn_s1)

    def _stability_scores(self, mask_logits):
        flat = mask_logits.reshape(*mask_logits.shape[:-2], -1)
        delta = self.dynamic_multimask_stability_delta
        area_i = jnp.sum(flat > delta, axis=-1).astype(jnp.float32)
        area_u = jnp.sum(flat > -delta, axis=-1).astype(jnp.float32)
        return jnp.where(area_u > 0, area_i / area_u, 1.0)

    def _dynamic_multimask(self, all_logits, all_iou):
        """(reference mask_decoder.py:215-260)"""
        multi_logits = all_logits[:, 1:]
        multi_iou = all_iou[:, 1:]
        best = jnp.argmax(multi_iou, axis=-1)
        bidx = jnp.arange(multi_iou.shape[0])
        best_logits = multi_logits[bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]
        single_logits = all_logits[:, :1]
        single_iou = all_iou[:, :1]
        stable = (self._stability_scores(single_logits)
                  >= self.dynamic_multimask_stability_thresh)
        masks = jnp.where(stable[..., None, None], single_logits,
                          best_logits)
        iou = jnp.where(stable, single_iou, best_iou)
        return masks, iou


class FpnNeck(nn.Module):
    """FPN neck with sine position encodings
    (reference backbones/image_encoder.py:44-134).  Input: trunk features
    low->high stride; output: d_model maps + pos encodings, same order."""
    d_model: int = 256
    backbone_channel_list: Sequence[int] = (768, 384, 192, 96)
    fpn_top_down_levels: Sequence[int] = (2, 3)
    fpn_interp_model: str = "nearest"
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, xs: Sequence[jnp.ndarray]):
        """xs: features ordered stride 4 -> 32 (hiera output order);
        backbone_channel_list is high-stride-first like the reference."""
        n = len(xs) - 1
        out: List[Optional[jnp.ndarray]] = [None] * len(xs)
        pos: List[Optional[jnp.ndarray]] = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = _NeckConv(self.d_model, self.param_dtype,
                                name=f"convs_{n - i}")(xs[i])
            if i in self.fpn_top_down_levels and prev is not None:
                top_down = interpolate_like_torch(
                    prev.astype(jnp.float32), scale_factor=2.0,
                    mode=self.fpn_interp_model).astype(lateral.dtype)
                prev = lateral + top_down
            else:
                prev = lateral
            out[i] = prev
            h, w = prev.shape[1:3]
            pe = jnp.asarray(sine_position_embedding_2d(h, w, self.d_model))
            pos[i] = jnp.broadcast_to(pe[None], prev.shape).astype(
                prev.dtype)
        return out, pos


class _NeckConv(nn.Module):
    """torch Sequential wrapper: convs.{i}.conv (image_encoder.py:76-87)."""
    features: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        return Conv2d(self.features, (1, 1), padding=0,
                      param_dtype=self.param_dtype, name="conv")(x)


class _RandomPositionEncoding(nn.Module):
    """PositionEmbeddingRandom (reference position_encoding.py:133-183);
    the gaussian matrix is a torch buffer named
    positional_encoding_gaussian_matrix."""
    num_pos_feats: int
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.positional_encoding_gaussian_matrix = self.param(
            "positional_encoding_gaussian_matrix",
            jax.nn.initializers.normal(1.0), (2, self.num_pos_feats),
            self.param_dtype)

    def encode(self, coords: jnp.ndarray) -> jnp.ndarray:
        """coords in [0,1]^2, [..., 2] -> [..., 2*num_pos_feats]."""
        coords = 2.0 * coords - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix.astype(
            coords.dtype)
        coords = 2.0 * jnp.pi * coords
        return jnp.concatenate([jnp.sin(coords), jnp.cos(coords)], axis=-1)

    def __call__(self, coords):
        return self.encode(coords)
