"""Context-parallel (ring attention) forward == single-device forward.

Runs on the 8-device CPU mesh: the clip's frame axis shards over 'seq',
temporal attention rides the ring; the result must match the unsharded
model numerically (fp32 online softmax is exact up to reduction order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from vdn.models.video_depth_anything import VideoDepthAnything
from vdn.parallel.context import (make_context_parallel_forward,
                                  ring_attention)
from vdn.parallel.mesh import SEQ_AXIS, make_mesh


def test_ring_attention_matches_full():
    mesh = make_mesh(data=1, seq=8)
    rng = np.random.default_rng(0)
    b, t, h, d = 2, 32, 4, 16  # t shards 8 x 4
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, h, d)).astype(np.float32)
    v = rng.standard_normal((b, t, h, d)).astype(np.float32)

    from vdn.ops.attention import dot_product_attention
    ref = np.asarray(dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), d ** -0.5))

    ring = shard_map(
        lambda q, k, v: ring_attention(q, k, v, SEQ_AXIS),
        mesh=mesh,
        in_specs=(P(None, SEQ_AXIS), P(None, SEQ_AXIS), P(None, SEQ_AXIS)),
        out_specs=P(None, SEQ_AXIS), check_vma=False)
    with mesh:
        got = np.asarray(jax.jit(ring)(q, k, v))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pe", ["ape", "rope"])
def test_context_parallel_video_model_matches(pe):
    mesh = make_mesh(data=2, seq=4)
    cfg = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64), pe=pe)
    single = VideoDepthAnything(**cfg)
    parallel = VideoDepthAnything(**cfg, seq_axis=SEQ_AXIS)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 56, 56, 3)).astype(np.float32)
    params = single.init(jax.random.PRNGKey(0), x[:1, :2])

    ref = np.asarray(single.apply(params, x))
    fwd = make_context_parallel_forward(parallel, mesh)
    with mesh:
        got = np.asarray(fwd(params, x))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_ring_attention_grad_matches_full():
    """Gradients through the ppermute ring equal full attention's."""
    from vdn.ops.attention import dot_product_attention

    mesh = make_mesh(data=1, seq=8, model=1)
    rng = np.random.default_rng(11)
    n, t, h, d = 8, 64, 2, 32
    q, k, v = (jnp.asarray(rng.standard_normal((n, t, h, d)),
                           jnp.float32) for _ in range(3))
    fn = shard_map(lambda q, k, v: ring_attention(q, k, v, SEQ_AXIS),
                   mesh=mesh, in_specs=(P(None, SEQ_AXIS),) * 3,
                   out_specs=P(None, SEQ_AXIS), check_vma=False)

    def loss(q, k, v):
        return jnp.sum(jnp.square(fn(q, k, v)))

    def loss_ref(q, k, v):
        return jnp.sum(jnp.square(dot_product_attention(q, k, v)))

    with mesh:
        got_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    want_g = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=3e-4, atol=3e-4)


def test_context_parallel_streaming_decode_matches():
    """Streaming decode with the KV window SHARDED over seq (the round-2
    gap: motion.py asserted seq_axis is None whenever a cache was
    present).  A 3-entry cache zero-padded to 4 shards one entry per
    device on a seq=4 mesh; cache_len=3 masks the pad; the decoded depth
    and the new cache entries must match the single-device concat path
    exactly."""
    mesh = make_mesh(data=2, seq=4)
    cfg = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64))
    single = VideoDepthAnything(**cfg)
    parallel = VideoDepthAnything(**cfg, seq_axis=SEQ_AXIS)

    rng = np.random.default_rng(7)
    window = rng.standard_normal((1, 3, 56, 56, 3)).astype(np.float32)
    new = rng.standard_normal((1, 1, 56, 56, 3)).astype(np.float32)
    params = single.init(jax.random.PRNGKey(0), window[:, :2])

    def run_window(m, x):
        f = m.forward_features(x)
        return m.forward_depth(f, x.shape)

    def run_cached(m, x, caches):
        f = m.forward_features(x)
        return m.forward_depth(f, x.shape, caches=caches)

    _, caches = single.apply(params, window, method=run_window)
    ref_depth, ref_new = single.apply(params, new, list(caches),
                                      method=run_cached)

    padded = tuple(jnp.pad(c, ((0, 0), (0, 1), (0, 0))) for c in caches)

    def local_step(params, x, caches):
        def run(m, x):
            f = m.forward_features(x)
            return m.forward_depth(f, x.shape, caches=list(caches),
                                   cache_len=3)
        return parallel.apply(params, x, method=run)

    sharded = shard_map(local_step, mesh=mesh,
                        in_specs=(P(), P(), P(None, SEQ_AXIS, None)),
                        out_specs=(P(), P()), check_vma=False)
    with mesh:
        got_depth, got_new = jax.jit(sharded)(params, new, padded)

    np.testing.assert_allclose(np.asarray(got_depth),
                               np.asarray(ref_depth),
                               rtol=2e-4, atol=2e-4)
    for g, r in zip(got_new, ref_new):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=2e-4, atol=2e-4)


def test_context_parallel_chunk_window_matches():
    """The FAST streaming path (batched chunk-window decode, the
    stream pipeline's k>1 mode) with the ring buffers SHARDED over seq:
    each device owns a contiguous shard of the ring's CAP axis, the
    one-hot window gather distributes over the shards, and one psum
    rebuilds the per-frame window logit map (vdn/nn/motion.py
    _chunk_window, CP branch).  Must match the single-device
    chunk-window decode exactly — which the existing
    test_streaming_chunked_matches_per_frame ties to the per-frame scan
    path (reference video_depth_stream.py:133-158)."""
    mesh = make_mesh(data=2, seq=4)
    cfg = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64))
    single = VideoDepthAnything(**cfg)
    parallel = VideoDepthAnything(**cfg, seq_axis=SEQ_AXIS)

    rng = np.random.default_rng(11)
    t0, k, cap_g, w = 4, 2, 8, 32
    window = rng.standard_normal((1, t0, 56, 56, 3)).astype(np.float32)
    chunk = rng.standard_normal((1, k, 56, 56, 3)).astype(np.float32)
    params = single.init(jax.random.PRNGKey(0), window[:, :2])

    def run_window(m, x):
        f = m.forward_features(x)
        return m.forward_depth(f, x.shape)

    _, entries = single.apply(params, window, method=run_window)
    # ring buffers: t0 live slots, the rest zero (never selected)
    buffers = tuple(
        jnp.zeros((e.shape[0], cap_g, e.shape[2]), e.dtype)
        .at[:, :t0].set(e) for e in entries)

    # full 32-entry windows exactly like the pipeline (repeat the live
    # slots, frame j's own entry at position w-1; frame 1 also reads
    # frame 0's in-chunk column)
    sel0 = [i % t0 for i in range(w - 1)] + [cap_g + 0]
    sel1 = [i % t0 for i in range(w - 2)] + [cap_g + 0, cap_g + 1]
    onehot = jax.nn.one_hot(jnp.asarray([sel0, sel1], jnp.int32),
                            cap_g + k, dtype=jnp.float32)

    def run_chunk(model, params, x, bufs, onehot):
        def run(m, x):
            ph, pw = x.shape[2] // 14, x.shape[3] // 14
            feats = m.forward_features(x)
            r1, r2, l3, l4 = m.head.decode_pre(feats, ph, pw)
            windows = tuple((buf, onehot) for buf in bufs)
            p3, ents = m.head.decode_temporal(
                l3, l4, tuple(r2.shape[-3:-1]), x.shape[1], caches=windows)
            return m.head.decode_post(p3, r1, r2, (ph * 14, pw * 14)), ents
        return model.apply(params, x, method=run)

    ref_depth, ref_ents = run_chunk(single, params, chunk, buffers, onehot)

    sharded = shard_map(
        lambda p_, x, bufs, oh: run_chunk(parallel, p_, x, bufs, oh),
        mesh=mesh,
        in_specs=(P(), P(), P(None, SEQ_AXIS, None), P()),
        out_specs=(P(), P()), check_vma=False)
    with mesh:
        got_depth, got_ents = jax.jit(sharded)(params, chunk, buffers,
                                               onehot)

    np.testing.assert_allclose(np.asarray(got_depth),
                               np.asarray(ref_depth),
                               rtol=2e-4, atol=2e-4)
    for g, r in zip(got_ents, ref_ents):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=2e-4, atol=2e-4)


def test_ulysses_matches_ring_and_full():
    from vdn.parallel.context import set_cp_mode, ulysses_attention
    mesh = make_mesh(data=1, seq=8)
    rng = np.random.default_rng(5)
    n, t, h, d = 16, 16, 2, 8
    q = rng.standard_normal((n, t, h, d)).astype(np.float32)
    k = rng.standard_normal((n, t, h, d)).astype(np.float32)
    v = rng.standard_normal((n, t, h, d)).astype(np.float32)
    from vdn.ops.attention import dot_product_attention
    ref = np.asarray(dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), d ** -0.5))
    uly = shard_map(
        lambda q, k, v: ulysses_attention(q, k, v, SEQ_AXIS),
        mesh=mesh,
        in_specs=(P(None, SEQ_AXIS),) * 3,
        out_specs=P(None, SEQ_AXIS), check_vma=False)
    with mesh:
        got = np.asarray(jax.jit(uly)(q, k, v))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)

    # full video model under alltoall mode matches single-device
    cfg = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64))
    single = VideoDepthAnything(**cfg)
    parallel = VideoDepthAnything(**cfg, seq_axis=SEQ_AXIS)
    x = rng.standard_normal((1, 8, 56, 56, 3)).astype(np.float32)
    params = single.init(jax.random.PRNGKey(0), x[:, :2])
    ref_out = np.asarray(single.apply(params, x))
    mesh2 = make_mesh(data=2, seq=4)
    set_cp_mode("alltoall")
    try:
        fwd = make_context_parallel_forward(parallel, mesh2)
        with mesh2:
            got_out = np.asarray(fwd(params, np.tile(x, (2, 1, 1, 1, 1))))
    finally:
        set_cp_mode("ring")
    np.testing.assert_allclose(got_out[:1], ref_out, rtol=2e-4, atol=2e-4)


def test_vit_tensor_parallel_matches():
    from vdn.nn.vit import make_vit
    from vdn.parallel.sharding import shard_params, vit_tp_rules
    from vdn.parallel.mesh import MODEL_AXIS
    mesh = make_mesh(data=1, seq=1, model=8)
    model = make_vit("vits")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), x)
    ref = np.asarray(model.apply(params, x))
    with mesh:
        sharded = shard_params(params, mesh)
        got = np.asarray(jax.jit(model.apply)(sharded, x))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # the wide kernels must actually be sharded over the model axis
    qkv = sharded["params"]["blocks_0"]["attn"]["qkv"]["kernel"]
    assert len(qkv.sharding.device_set) == 8


def test_vitg_swiglu_tensor_parallel_matches():
    """The vitg family uses SwiGLU (w12/w3) — exercise those TP rules
    numerically on a small SwiGLU ViT over the 8-way model axis."""
    from vdn.nn.vit import DinoVisionTransformer
    from vdn.parallel.sharding import shard_params
    mesh = make_mesh(data=1, seq=1, model=8)
    model = DinoVisionTransformer(embed_dim=256, depth=2, num_heads=8,
                                  ffn="swiglufused")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), x)
    ref = np.asarray(model.apply(params, x))
    with mesh:
        sharded = shard_params(params, mesh)
        got = np.asarray(jax.jit(model.apply)(sharded, x))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    w12 = sharded["params"]["blocks_0"]["mlp"]["w12"]["kernel"]
    assert len(w12.sharding.device_set) == 8


def test_tp_coverage_assertion_on_vitg_tree():
    """Coverage guard: the REAL vitg (1.3B) param tree — via eval_shape,
    no materialization — has every wide matmul matched by a rule; a
    renamed layer trips the assertion instead of silently replicating."""
    from vdn.nn.vit import make_vit
    from vdn.parallel.sharding import assert_tp_coverage, vit_tp_rules

    model = make_vit("vitg")
    params = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 56, 56, 3), np.float32))
    # full vitg tree passes
    assert_tp_coverage(params)

    # simulate a rename of the matmul itself (rules match the kernel's
    # parent module name, so renaming w12 -> w12_fused falls through)
    blk = {k: dict(v) for k, v in params["params"]["blocks_0"].items()}
    blk["mlp"]["w12_fused"] = blk["mlp"].pop("w12")
    broken = {"params": {**params["params"], "blocks_0": blk}}
    rules = vit_tp_rules(broken)
    with pytest.raises(ValueError, match="replicated"):
        assert_tp_coverage(broken, rules)
