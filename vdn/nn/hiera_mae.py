"""Plain (MAE-pretrained) Hiera backbone.

The v1 research model's image/depth encoders are the torch-hub MAE Hiera
(reference models/hiera_image_encoder.py:35 — ``torch.hub.load(
"facebookresearch/hiera", ...)`` with ``return_intermediates=True``), NOT
the SAM2 "hieradet" variant (`vdn/nn/hiera.py`).  The two families differ
architecturally: plain Hiera has a single dense position embedding, no
windowed-background pos-embed split, no fixed global-attention block list,
and runs "mask unit attention" over an *unrolled* token ordering with
query pooling folded into the attention (hub hiera.py:MaskUnitAttention),
whereas hieradet window-partitions spatially per block.

This module matches the hub architecture exactly so reference v1
checkpoints (whose state dicts embed hub-layout keys, ``blocks.{i}.*``)
convert mechanically.  Numerics are verified against the transformers
``HieraModel`` port — the only faithful MAE-Hiera implementation available
offline — in tests/test_hiera_mae_parity.py (weights converted HF->vdn,
stage intermediates + pooled output compared).

Notes: the unroll/reroll token re-orderings are pure reshapes +
transposes (XLA lowers them to layout changes / fused copies); attention
runs as head-batched einsums with an fp32-softmax island; all shapes are
static so every variant jits once.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.layers import LayerNorm, Linear, Mlp, Conv2d
from vdn.ops.resize import interpolate_like_torch

Dtype = Any

# torch-hub configs (hub hiera.py:486-552): embed_dim, initial head count,
# per-stage depths.  All share q_pool=3, q_stride 2x2, mask unit 8x8,
# patch conv 7x7/s4/p3, mlp_ratio 4, dim x2 and heads x2 per stage.
HIERA_MAE_CONFIGS = {
    "hiera_tiny_224": dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2)),
    "hiera_small_224": dict(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2)),
    "hiera_base_224": dict(embed_dim=96, num_heads=1, stages=(2, 3, 16, 3)),
    "hiera_base_plus_224": dict(embed_dim=112, num_heads=2,
                                stages=(2, 3, 16, 3)),
    "hiera_large_224": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4)),
    "hiera_huge_224": dict(embed_dim=256, num_heads=4, stages=(2, 6, 36, 4)),
}

_Q_STRIDE = (2, 2)
_MASK_UNIT = (8, 8)
_Q_POOL = 3  # number of pooling stage-transitions


def unroll_tokens(x: jnp.ndarray, size: Tuple[int, int],
                  schedule: Sequence[Tuple[int, int]]) -> jnp.ndarray:
    """Reorder [B, h*w, C] row-major tokens into Hiera's unrolled order.

    After unrolling, index bits run [s1h, s1w, s2h, s2w, ..., h', w']:
    pooling offsets most-significant, mask-unit index least-significant —
    so a 2x2 max-pool is ``view(B, 4, -1, C).max(1)`` and a mask unit's
    tokens sit at a fixed stride (hub hiera utils ``Unroll``)."""
    b, _, c = x.shape
    cur = list(size)
    batch = b
    x = x.reshape(batch, cur[0], cur[1], c)
    for sh, sw in schedule:
        cur = [cur[0] // sh, cur[1] // sw]
        x = x.reshape(batch, cur[0], sh, cur[1], sw, c)
        x = x.transpose(0, 2, 4, 1, 3, 5)
        x = x.reshape(batch * sh * sw, cur[0], cur[1], c)
        batch *= sh * sw
    return x.reshape(b, size[0] * size[1], c)


def reroll_tokens(x: jnp.ndarray, size: Tuple[int, int],
                  schedule: Sequence[Tuple[int, int]]) -> jnp.ndarray:
    """Inverse of ``unroll_tokens`` for a feature that has consumed the
    leading ``len(full_schedule) - len(schedule)`` pool levels: [B, N, C]
    -> spatial [B, size_h, size_w, C] (hub hiera utils ``Reroll``)."""
    b, n, c = x.shape
    mu = [1, 1]
    for sh, sw in schedule:
        n //= sh * sw
        x = x.reshape(b, sh, sw, n, mu[0], mu[1], c)
        x = x.transpose(0, 3, 1, 4, 2, 5, 6)
        mu = [mu[0] * sh, mu[1] * sw]
        x = x.reshape(b, n, mu[0], mu[1], c)
    nh, nw = size[0] // mu[0], size[1] // mu[1]
    x = x.reshape(b, nh, nw, mu[0], mu[1], c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, size[0], size[1], c)


class MaePatchEmbed(nn.Module):
    """7x7/s4 conv patchify (hub hiera.py:PatchEmbed); submodule named
    ``proj`` so hub keys ``patch_embed.proj.*`` convert mechanically."""
    embed_dim: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):  # [B, H, W, 3] -> [B, H/4, W/4, C]
        return Conv2d(self.embed_dim, (7, 7), stride=(4, 4), padding=3,
                      param_dtype=self.param_dtype, name="proj")(x)


class MaskUnitAttention(nn.Module):
    """Attention within mask-unit windows (or global), with query pooling
    folded in (hub hiera.py:MaskUnitAttention; HF HieraMaskUnitAttention).

    Operates on unrolled tokens: the window index is the token axis's
    least-significant part, pooling offsets the most-significant."""
    dim_out: int
    heads: int
    q_stride: int = 1
    window_size: int = 0
    use_mask_unit_attn: bool = False
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        b, n, _ = x.shape
        h = self.heads
        hd = self.dim_out // h
        num_win = 1
        if self.use_mask_unit_attn:
            num_win = n // (self.q_stride * self.window_size)
        qkv = Linear(3 * self.dim_out, param_dtype=self.param_dtype,
                     name="qkv")(x)
        # token axis = (intra-window major, window minor)
        qkv = qkv.reshape(b, n // num_win, num_win, 3, h, hd)
        qkv = qkv.transpose(3, 0, 4, 2, 1, 5)  # [3, B, h, win, intra, hd]
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.q_stride > 1:
            # unrolled-order max-pool over the leading intra offsets
            q = q.reshape(b, h, num_win, self.q_stride, -1, hd).max(axis=3)
        logits = jnp.einsum("bhwqd,bhwkd->bhwqk", q, k,
                            preferred_element_type=jnp.float32)
        logits = logits * (hd ** -0.5)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhwqk,bhwkd->bhwqd", probs, v)
        # [B, h, win, q, hd] -> [B, q, win, h, hd] -> [B, N_q, dim_out]
        out = out.transpose(0, 3, 2, 1, 4).reshape(b, -1, self.dim_out)
        return Linear(self.dim_out, param_dtype=self.param_dtype,
                      name="proj")(out)


class HieraMaeBlock(nn.Module):
    """norm1 -> (proj + unrolled max-pool on dim change) -> attn -> res;
    norm2 -> MLP -> res (hub hiera.py:HieraBlock)."""
    dim: int
    dim_out: int
    heads: int
    mlp_ratio: float = 4.0
    q_stride: int = 1
    window_size: int = 0
    use_mask_unit_attn: bool = False
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        pd = self.param_dtype
        y = LayerNorm(param_dtype=pd, name="norm1")(x)
        if self.dim != self.dim_out:
            x = Linear(self.dim_out, param_dtype=pd, name="proj")(y)
            b = x.shape[0]
            x = x.reshape(b, self.q_stride, -1, self.dim_out).max(axis=1)
        x = x + MaskUnitAttention(
            self.dim_out, self.heads, self.q_stride, self.window_size,
            self.use_mask_unit_attn, pd, name="attn")(y)
        y = LayerNorm(param_dtype=pd, name="norm2")(x)
        y = Mlp(int(self.dim_out * self.mlp_ratio), self.dim_out,
                param_dtype=pd, name="mlp")(y)
        return x + y


class HieraMae(nn.Module):
    """Plain MAE Hiera trunk.

    ``__call__(x, return_intermediates=True)`` mirrors the hub forward
    contract the reference consumes (hiera_image_encoder.py:44-61):
    returns (pooled [B, C_last] — the mean-token trunk-norm output; the
    reference ignores it — and 4 spatial NHWC stage maps
    [B, 56, 56, 96] ... [B, 7, 7, 768] for base@224)."""
    embed_dim: int = 96
    num_heads: int = 1
    stages: Sequence[int] = (2, 3, 16, 3)
    img_size: int = 224
    mlp_ratio: float = 4.0
    param_dtype: Dtype = jnp.float32

    def setup(self):
        pd = self.param_dtype
        self.patch_embed = MaePatchEmbed(self.embed_dim, pd)
        grid = self.img_size // 4
        self.pos_grid = (grid, grid)
        self.pos_embed = self.param(
            "pos_embed", jax.nn.initializers.normal(0.02),
            (1, grid * grid, self.embed_dim), pd)

        depths = list(self.stages)
        cum = [0]
        for d in depths:
            cum.append(cum[-1] + d)
        pool_blocks = set(cum[1:1 + _Q_POOL])  # first block of stages 1..3
        q_area = _Q_STRIDE[0] * _Q_STRIDE[1]
        mu_area = _MASK_UNIT[0] * _MASK_UNIT[1]

        blocks = []
        for i in range(cum[-1]):
            stage = next(s for s in range(len(depths))
                         if cum[s] <= i < cum[s + 1])
            dim = int(self.embed_dim * 2 ** stage)
            dim_in = dim // 2 if i == cum[stage] and stage > 0 else dim
            heads = self.num_heads * 2 ** stage
            q_stride = q_area if i in pool_blocks else 1
            window = max(1, mu_area // q_area ** stage)
            # stages 0/1 window-attend; the first block after a pooling
            # stage lags one block at the lower resolution (hub
            # hiera.py:448-452 "use_mask_unit_attn ... lag by 1 layer")
            mask_attn = stage < 2 or (stage == 2 and i == cum[2])
            blocks.append(HieraMaeBlock(
                dim_in, dim, heads, self.mlp_ratio, q_stride, window,
                mask_attn, self.param_dtype, name=f"blocks_{i}"))
        self.blocks = blocks
        self._cum = cum
        self.norm = LayerNorm(param_dtype=pd, name="norm")

    def _pos(self, gh: int, gw: int, dtype) -> jnp.ndarray:
        pos = self.pos_embed.astype(jnp.float32)
        if (gh, gw) != self.pos_grid:
            pos = pos.reshape(1, *self.pos_grid, self.embed_dim)
            pos = interpolate_like_torch(pos, size=(gh, gw), mode="bicubic")
            pos = pos.reshape(1, gh * gw, self.embed_dim)
        return pos.astype(dtype)

    def __call__(self, x: jnp.ndarray, return_intermediates: bool = True):
        b, hh, ww, _ = x.shape
        gh, gw = hh // 4, ww // 4
        tokens = self.patch_embed(x).reshape(b, gh * gw, -1)
        tokens = tokens + self._pos(gh, gw, tokens.dtype)

        full_schedule = [_Q_STRIDE] * (len(self.stages) - 1)
        tokens = unroll_tokens(tokens, (gh, gw), full_schedule)

        cum = self._cum
        stage_ends = {cum[s + 1] - 1: s for s in range(len(self.stages))}
        size = [gh, gw]
        schedule = list(full_schedule)
        intermediates: List[jnp.ndarray] = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            s = stage_ends.get(i)
            if s is not None:
                if return_intermediates:
                    intermediates.append(
                        reroll_tokens(tokens, tuple(size), schedule))
                if s < _Q_POOL:  # the next stage opens with a q-pool block
                    size = [size[0] // _Q_STRIDE[0], size[1] // _Q_STRIDE[1]]
                    schedule = schedule[1:]

        pooled = self.norm(jnp.mean(tokens, axis=1))
        if return_intermediates:
            return pooled, intermediates
        return pooled


def make_hiera_mae(variant: str = "hiera_base_224",
                   param_dtype=jnp.float32,
                   name: Optional[str] = None) -> HieraMae:
    cfg = HIERA_MAE_CONFIGS[variant]
    kw = {} if name is None else {"name": name}
    return HieraMae(embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
                    stages=cfg["stages"], param_dtype=param_dtype, **kw)
