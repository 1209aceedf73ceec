"""DINOv2 vision transformer.

Re-design of the reference encoder (reference depth_anything_v2/dinov2.py:44-415
and dinov2_layers/): NHWC input, [B, N, C] tokens, fp32 LayerNorm /
softmax islands, optional remat for training, and fused attention
(vdn.ops.attention).
Checkpoints convert 1:1 (see vdn/core/convert.py); forward matches the torch
reference to fp32 tolerance (tests/test_vit_parity.py).

Factory configs (reference dinov2.py:339-415):
  vits: 384 dim / 12 blocks /  6 heads      vitb: 768 / 12 / 12
  vitl: 1024 / 24 / 16                      vitg: 1536 / 40 / 24 (SwiGLU FFN)
All with patch 14, img_size 518 (37x37 = 1369 pos-embed patches),
layer-scale init 1.0, interpolate_offset 0.1.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from vdn.nn import module as nn
from vdn.nn.layers import LayerNorm, Linear, Mlp, SwiGLUFFN, Conv2d
from vdn.ops.attention import dot_product_attention
from vdn.ops.resize import interpolate_like_torch

Dtype = Any

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6, ffn="mlp"),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12, ffn="mlp"),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16, ffn="mlp"),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24, ffn="swiglufused"),
}

# which intermediate blocks feed the DPT head, per encoder size
# (reference depth_anything_v2/depth_anything_v2.py:24-29)
INTERMEDIATE_LAYER_IDX = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
    "vitg": [9, 19, 29, 39],
}


# Block remat keeps the attention-residual midpoint of each block, so the
# backward recomputes each half of the block from a saved input once.
REMAT_POLICY = jax.checkpoint_policies.save_only_these_names("attn_res")


class PatchEmbed(nn.Module):
    embed_dim: int
    patch_size: int = 14
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):  # [B, H, W, 3] -> [B, gh*gw, C]
        p = self.patch_size
        proj = Conv2d(self.embed_dim, (p, p), stride=(p, p), padding=0,
                      param_dtype=self.param_dtype, name="proj")
        b, h, w, cin = x.shape
        if h % p or w % p:  # ragged input: let the conv drop the remainder
            y = proj(x)
            return y.reshape(b, -1, self.embed_dim)
        # non-overlapping stride-p conv == unfold + one matmul, which
        # avoids a C_in=3 conv over the full frame.  Matches reference
        # dinov2_layers/patch_embed.py:66-73 (proj conv + flatten) exactly.
        kernel, bias = proj(x, params_only=True)
        gh, gw = h // p, w // p
        xt = x.reshape(b, gh, p, gw, p, cin).transpose(0, 1, 3, 2, 4, 5)
        xt = xt.reshape(b, gh * gw, p * p * cin)
        y = jnp.matmul(xt, kernel.reshape(p * p * cin,
                                          self.embed_dim).astype(x.dtype))
        return y + bias.astype(y.dtype)


class LayerScale(nn.Module):
    dim: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        gamma = self.param("gamma", jax.nn.initializers.ones, (self.dim,),
                           self.param_dtype)
        return x * gamma.astype(x.dtype)


class Attention(nn.Module):
    num_heads: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        """x [B, N, C] -> [B, N, C]."""
        b, n, c = x.shape
        h = self.num_heads
        qkv = Linear(3 * c, param_dtype=self.param_dtype, name="qkv")(x)
        qkv = qkv.reshape(b, n, 3, h, c // h)
        out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        out = out.reshape(b, n, c)
        return Linear(c, param_dtype=self.param_dtype, name="proj")(out)


class Block(nn.Module):
    num_heads: int
    mlp_ratio: float = 4.0
    ffn: str = "mlp"
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        y = Attention(self.num_heads, self.param_dtype, name="attn")(
            LayerNorm(param_dtype=self.param_dtype, name="norm1")(x))
        # named for REMAT_POLICY (identity outside jax.checkpoint)
        x = checkpoint_name(x + LayerScale(c, self.param_dtype,
                                           name="ls1")(y), "attn_res")
        y = LayerNorm(param_dtype=self.param_dtype, name="norm2")(x)
        if self.ffn == "mlp":
            y = Mlp(int(c * self.mlp_ratio), c,
                    param_dtype=self.param_dtype, name="mlp")(y)
        else:  # swiglufused: hidden = multiple-of-8 round of 2/3 * 4d
            hidden = int(c * self.mlp_ratio) * 2 // 3
            hidden = (hidden + 7) // 8 * 8
            y = SwiGLUFFN(hidden, c, param_dtype=self.param_dtype,
                          name="mlp")(y)
        return x + LayerScale(c, self.param_dtype, name="ls2")(y)


class DinoVisionTransformer(nn.Module):
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ffn: str = "mlp"
    patch_size: int = 14
    img_size: int = 518
    interpolate_offset: float = 0.1
    param_dtype: Dtype = jnp.float32
    remat: bool = False

    def setup(self):
        grid = self.img_size // self.patch_size
        self.num_pos_patches = grid * grid
        self.patch_embed = PatchEmbed(self.embed_dim, self.patch_size,
                                      self.param_dtype)
        self.cls_token = self.param("cls_token", jax.nn.initializers.zeros,
                                    (1, 1, self.embed_dim), self.param_dtype)
        self.pos_embed = self.param(
            "pos_embed", jax.nn.initializers.normal(0.02),
            (1, self.num_pos_patches + 1, self.embed_dim), self.param_dtype)
        # kept for checkpoint-key parity with the reference (masking unused)
        self.mask_token = self.param("mask_token", jax.nn.initializers.zeros,
                                     (1, self.embed_dim), self.param_dtype)
        block_cls = nn.remat(Block, policy=REMAT_POLICY) if self.remat \
            else Block
        self.blocks = [
            block_cls(self.num_heads, self.mlp_ratio, self.ffn,
                      self.param_dtype, name=f"blocks_{i}")
            for i in range(self.depth)
        ]
        self.norm = LayerNorm(param_dtype=self.param_dtype, name="norm")

    def _interpolated_pos_embed(self, gh: int, gw: int, dtype) -> jnp.ndarray:
        """Bicubic pos-embed interpolation with the reference's offset-0.1
        scale_factor convention (reference dinov2.py:179-210)."""
        n = self.num_pos_patches
        pos = self.pos_embed.astype(jnp.float32)
        if gh * gw == n and gh == gw:
            return pos.astype(dtype)
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        grid = int(math.sqrt(n))
        sh = (gh + self.interpolate_offset) / grid
        sw = (gw + self.interpolate_offset) / grid
        patch_pos = patch_pos.reshape(1, grid, grid, self.embed_dim)
        patch_pos = interpolate_like_torch(patch_pos, scale_factor=(sh, sw),
                                           mode="bicubic")
        assert patch_pos.shape[1] == gh and patch_pos.shape[2] == gw
        patch_pos = patch_pos.reshape(1, gh * gw, self.embed_dim)
        return jnp.concatenate([cls_pos, patch_pos], axis=1).astype(dtype)

    def prepare_tokens(self, x: jnp.ndarray) -> jnp.ndarray:
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        tokens = self.patch_embed(x)
        cls = jnp.broadcast_to(self.cls_token.astype(tokens.dtype),
                               (b, 1, self.embed_dim))
        tokens = jnp.concatenate([cls, tokens], axis=1)
        return tokens + self._interpolated_pos_embed(gh, gw, tokens.dtype)

    def get_intermediate_layers(
            self, x: jnp.ndarray, layer_idx: Sequence[int],
            norm: bool = True) -> List[Tuple[jnp.ndarray, jnp.ndarray]]:
        """Returns [(patch_tokens [B,N,C], cls_token [B,C])] for each
        requested block index, layer-normed (reference dinov2.py:297-321)."""
        wanted = set(int(i) for i in layer_idx)
        tokens = self.prepare_tokens(x)
        outs = {}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in wanted:
                outs[i] = tokens
            if len(outs) == len(wanted) and i >= max(wanted):
                break
        result = []
        for i in sorted(outs):
            t = self.norm(outs[i]) if norm else outs[i]
            result.append((t[:, 1:], t[:, 0]))
        return result

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        tokens = self.prepare_tokens(x)
        for blk in self.blocks:
            tokens = blk(tokens)
        return self.norm(tokens)


def make_vit(encoder: str, param_dtype=jnp.float32, remat: bool = False,
             name: Optional[str] = None) -> DinoVisionTransformer:
    cfg = VIT_CONFIGS[encoder]
    kw = {} if name is None else {"name": name}
    return DinoVisionTransformer(
        embed_dim=cfg["embed_dim"], depth=cfg["depth"],
        num_heads=cfg["num_heads"], ffn=cfg["ffn"],
        param_dtype=param_dtype, remat=remat, **kw)
