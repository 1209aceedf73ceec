"""Sharded-vs-single-device trainer parity on the virtual CPU mesh.

The reference's only distributed feature is DDP training
(reference metric_depth/train.py:93-96, scripts/train_v4.py:443-470 via
torchrun).  Here the equivalent is the mesh-aware jitted step: params
replicated, batch pinned to the 'data' axis, XLA inserting the gradient
all-reduce.  These tests assert the sharded step computes the SAME loss
and gradients as the unsharded one — the DDP==single-process
equivalence DDP itself guarantees (up to all-reduce summation order,
hence the absolute-tolerance floor: a leaf whose true gradient is ~1e-9
by cancellation can legitimately flip sign under re-ordering, exactly
as under NCCL ring reduction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vdn.parallel.mesh import make_mesh


def _grads_allclose(a, b, rtol=1e-4, atol=1e-7):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for (path, la), lb in zip(flat_a, flat_b):
        np.testing.assert_allclose(
            np.asarray(la), np.asarray(lb), rtol=rtol, atol=atol,
            err_msg=jax.tree_util.keystr(path))


def _dp_jit(fn, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    bs = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    return jax.jit(fn, in_shardings=(rep, bs, bs, bs), out_shardings=rep)


@pytest.mark.slow
def test_refine_trainer_mesh_parity():
    from vdn.models.refine import RefineVideoDepth
    from vdn.train.trainer import RefineTrainer

    model = RefineVideoDepth(version=4, encoder="vits", features=32,
                             out_channels=(32, 32, 64, 64))
    rng = np.random.default_rng(0)
    batch = {
        "depth_anything_v2": (rng.random((4, 2, 28, 28)) * 65535
                              ).astype(np.float32),
        "depth": (rng.random((4, 2, 28, 28)) * 10 + 0.5).astype(np.float32),
        "mask": np.ones((4, 2, 28, 28), np.float32),
    }
    params = model.init(jax.random.PRNGKey(0),
                        batch["depth_anything_v2"][:1, :2])
    mesh = make_mesh(data=4, devices=jax.devices()[:4])
    trainer = RefineTrainer(model, initial_lr=1e-3, stable_scale=1.0,
                            mesh=mesh)

    def loss_fn(p, x, d, m):
        gt = 1.0 / jnp.clip(d, 1e-8, None)
        total, _ = trainer._loss(p, x, gt, m)
        return total

    args = (jnp.asarray(batch["depth_anything_v2"]),
            jnp.asarray(batch["depth"]), jnp.asarray(batch["mask"]))
    l_s, g_s = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
    l_m, g_m = _dp_jit(jax.value_and_grad(loss_fn), mesh)(params, *args)
    np.testing.assert_allclose(float(l_m), float(l_s), rtol=1e-5)
    _grads_allclose(g_s, g_m)

    # and the full mesh-jitted train step executes: real video_depth_loss
    # (radix select), frozen temporal head, AdamW warm-restart update
    state = trainer.init_state(jax.tree.map(np.array, params))
    frozen_before = jax.tree_util.tree_leaves(
        state.params["params"]["temporal_head"])[0].copy()
    state, loss_dict = trainer.train_step(state, batch)
    assert np.isfinite(float(loss_dict["total_loss"]))
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(
            state.params["params"]["temporal_head"])[0]), frozen_before)
    ev = trainer.eval_step(state, batch)
    assert np.isfinite(float(ev["total_loss"]))


@pytest.mark.slow
def test_metric_trainer_mesh_parity():
    from vdn.models.metric_depth import MetricDepthAnythingV2
    from vdn.train.metric_depth import MetricDepthTrainer

    model = MetricDepthAnythingV2(encoder="vits", features=32,
                                  out_channels=(32, 32, 64, 64),
                                  max_depth=20.0)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
    depth = (rng.random((4, 28, 28)) * 10 + 0.5).astype(np.float32)
    mask = np.ones((4, 28, 28), np.float32)
    params = model.init(jax.random.PRNGKey(0), img[:1])
    mesh = make_mesh(data=4, devices=jax.devices()[:4])
    trainer = MetricDepthTrainer(model, base_lr=1e-3, total_iters=100,
                                 mesh=mesh)

    args = (jnp.asarray(img), jnp.asarray(depth), jnp.asarray(mask))
    l_s, g_s = jax.jit(jax.value_and_grad(trainer._loss))(params, *args)
    l_m, g_m = _dp_jit(jax.value_and_grad(trainer._loss), mesh)(
        params, *args)
    np.testing.assert_allclose(float(l_m), float(l_s), rtol=1e-5)
    _grads_allclose(g_s, g_m)

    # full mesh-jitted SiLog train step executes
    mp, mo = trainer.init_state(jax.tree.map(np.array, params))
    mp, mo, loss = trainer._train_step(mp, mo, img, depth, mask)
    assert np.isfinite(float(loss))
