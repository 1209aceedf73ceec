"""Replay committed golden reference activations (tests/goldens/*.npz)
through the vdn modules — no live torch reference needed.

Goldens are produced by tools/make_goldens.py: seeded reference weights
(fp32) + structured inputs + fp64 reference outputs.  They freeze the
parity evidence independent of the reference checkout and at better than
fp32 reference precision.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vdn.core.convert import convert_torch_state

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def load(name):
    z = np.load(os.path.join(GOLDENS, f"{name}.npz"), allow_pickle=False)
    weights = {k[3:]: z[k] for k in z.files if k.startswith("w::")}
    inputs = [z[k] for k in sorted(k for k in z.files
                                   if k.startswith("in::"))]
    outputs = [z[k] for k in sorted(k for k in z.files
                                    if k.startswith("out::"))]
    return weights, inputs, outputs


def test_golden_vit():
    from vdn.nn.vit import DinoVisionTransformer
    weights, (x,), outs = load("vit_tiny_d3")
    model = DinoVisionTransformer(embed_dim=64, depth=3, num_heads=4)
    params = {"params": convert_torch_state(weights)}
    got = model.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)),
                      [0, 2], method=model.get_intermediate_layers)
    flat = [t for pair in got for t in pair]
    assert len(flat) == len(outs)
    for g, o in zip(flat, outs):
        np.testing.assert_allclose(np.asarray(g), o.astype(np.float32),
                                   rtol=1e-4, atol=1e-5)


def test_golden_dpt_head():
    from vdn.nn.dpt import DPTHead
    weights, (feats,), outs = load("dpt_head")
    model = DPTHead(in_channels=64, features=32,
                    out_channels=(24, 48, 96, 96))
    params = {"params": convert_torch_state(
        weights, convt_patterns=[r"resize_layers\.[01]\."])}
    items = [(jnp.asarray(f), None) for f in feats]
    depth, feat = model.apply(params, items, 6, 6)
    ref_depth, ref_feat = outs
    np.testing.assert_allclose(np.asarray(depth)[..., 0],
                               ref_depth[:, 0].astype(np.float32),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(feat).transpose(0, 3, 1, 2),
                               ref_feat.astype(np.float32),
                               rtol=1e-4, atol=1e-5)


def test_golden_temporal_module():
    from vdn.nn.motion import TemporalModule
    weights, (x,), outs = load("temporal_module")
    b, c, s, h, w = x.shape
    model = TemporalModule(in_channels=c, num_attention_heads=4,
                           num_transformer_block=1, num_attention_blocks=2,
                           temporal_max_len=8)
    params = {"params": convert_torch_state(weights)}
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 4, 1).reshape(b * s, h, w, c))
    got, caches = model.apply(params, x_nhwc, s)
    ref_out = outs[0]  # [b, c, s, h, w]
    got_ref_layout = np.asarray(got).reshape(b, s, h, w, c).transpose(
        0, 4, 1, 2, 3)
    np.testing.assert_allclose(got_ref_layout, ref_out.astype(np.float32),
                               rtol=1e-4, atol=1e-5)
    # the reference caches each attention block's input; vdn caches the
    # position-free packed K/V of that input ([K | V | 0] lanes,
    # head-major rows; vdn/nn/motion.py), so pack the golden inputs
    # through the same to_k/to_v weights
    blk = params["params"]["temporal_transformer"]["transformer_blocks_0"]
    heads, dh = 4, c // 4
    for i, (g, o) in enumerate(zip(caches, outs[1:])):
        att = blk[f"attention_blocks_{i}"]
        o = o.astype(np.float64)
        bn, t = o.shape[:2]
        hv = lambda a: a.reshape(bn, t, heads, dh).transpose(2, 0, 1, 3)
        k = hv(o @ np.asarray(att["to_k"]["kernel"], np.float64))
        v = hv(o @ np.asarray(att["to_v"]["kernel"], np.float64))
        pad = np.zeros(k.shape[:-1] + (g.shape[-1] - 2 * dh,))
        want = np.concatenate([k, v, pad], -1).reshape(heads * bn, t, -1)
        np.testing.assert_allclose(np.asarray(g), want, rtol=1e-4,
                                   atol=1e-4)


def test_golden_memory_attention():
    from vdn.nn.memory import MemoryAttention
    weights, (curr, memory, curr_pos, memory_pos), outs = load(
        "memory_attention")
    model = MemoryAttention(d_model=32, num_heads=2, num_layers=2,
                            dim_feedforward=64, activation="relu",
                            pos_enc_at_cross_attn_queries=False,
                            pos_enc_at_cross_attn_keys=True)
    params = {"params": convert_torch_state(weights)}
    got = model.apply(params, jnp.asarray(curr), jnp.asarray(memory),
                      jnp.asarray(curr_pos), (6, 6),
                      memory_pos=jnp.asarray(memory_pos))
    np.testing.assert_allclose(np.asarray(got),
                               outs[0].astype(np.float32),
                               rtol=1e-4, atol=1e-5)


def test_golden_video_depth_loss():
    from vdn.train import losses as L
    z = np.load(os.path.join(GOLDENS, "video_depth_loss.npz"),
                allow_pickle=False)
    got = L.video_depth_loss(z["in::pred"], z["in::gt"],
                             z["in::mask"].astype(np.float32),
                             alpha=0.5, stable_scale=10.0)
    keys = [str(k) for k in z["out::logkeys"]]
    vals = z["out::logvals"]
    for k, v in zip(keys, vals):
        if k in got:
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4,
                                       atol=1e-5, err_msg=k)
    assert "total_loss" in keys and "total_loss" in got
