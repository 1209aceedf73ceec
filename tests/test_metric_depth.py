"""Metric-depth stack parity: SiLog loss, eval metrics, poly LR."""

import numpy as np
import torch

from tests import _reference

_reference.add_reference_to_path()

import importlib  # noqa: E402

ref_loss_mod = importlib.import_module("metric_depth.util.loss")
ref_metric_mod = importlib.import_module("metric_depth.util.metric")

from vdn.train.metric_depth import (eval_depth, poly_schedule,  # noqa: E402
                                    silog_loss)


def test_silog_matches():
    rng = np.random.default_rng(0)
    pred = (rng.random((2, 16, 16)) * 5 + 0.1).astype(np.float32)
    target = (rng.random((2, 16, 16)) * 5 + 0.1).astype(np.float32)
    mask = rng.random((2, 16, 16)) > 0.3
    ref = ref_loss_mod.SiLogLoss()
    with torch.no_grad():
        r = float(ref(torch.from_numpy(pred), torch.from_numpy(target),
                      torch.from_numpy(mask)))
    g = float(silog_loss(pred, target, mask))
    np.testing.assert_allclose(g, r, rtol=1e-5)


def test_eval_depth_matches():
    rng = np.random.default_rng(1)
    pred = torch.from_numpy((rng.random(500) * 5 + 0.1).astype(np.float32))
    target = torch.from_numpy((rng.random(500) * 5 + 0.1).astype(np.float32))
    ref = ref_metric_mod.eval_depth(pred, target)
    got = eval_depth(pred.numpy(), target.numpy())
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


def test_poly_schedule():
    sched = poly_schedule(1e-4, 100)
    assert abs(float(sched(0)) - 1e-4) < 1e-9  # fp32 rounding
    assert float(sched(100)) == 0.0
    expected = 1e-4 * (1 - 50 / 100) ** 0.9
    np.testing.assert_allclose(float(sched(50)), expected, rtol=1e-6)


def test_metric_trainer_step_runs():
    import jax
    from vdn.models.metric_depth import MetricDepthAnythingV2
    from vdn.train.metric_depth import MetricDepthTrainer
    model = MetricDepthAnythingV2(encoder="vits", features=32,
                                  out_channels=(32, 32, 64, 64),
                                  max_depth=20.0)
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.standard_normal((2, 56, 56, 3)).astype(np.float32),
        "depth": (rng.random((2, 56, 56)) * 10 + 0.5).astype(np.float32),
        "valid_mask": np.ones((2, 56, 56), np.float32),
    }
    params = model.init(jax.random.PRNGKey(0), batch["image"])
    trainer = MetricDepthTrainer(model, base_lr=1e-4, total_iters=100)
    state = trainer.init_state(params)
    losses = []
    for _ in range(3):
        state, loss = trainer.train_step(state, batch,
                                         np.random.default_rng(5))
        losses.append(loss)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
