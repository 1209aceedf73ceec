"""Trainer: schedule parity with torch, frozen params, loss goes down."""

import jax
import numpy as np
import pytest
import torch

from vdn.models.refine import RefineVideoDepth
from vdn.train.trainer import (RefineTrainer, cosine_warm_restarts,
                               preprocess_depth_sequences, rename_with_map,
                               V4_RENAME_MAP)


def test_schedule_matches_torch_warm_restarts():
    lr0, t0, tm = 1e-4, 10, 2
    m = torch.nn.Linear(1, 1)
    opt = torch.optim.AdamW(m.parameters(), lr=lr0)
    sch = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        opt, T_0=t0, T_mult=tm, eta_min=1e-6)
    ours = cosine_warm_restarts(lr0, t0, tm, 1e-6)
    torch_lrs = []
    for step in range(80):
        torch_lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sch.step()
    got = [float(ours(s)) for s in range(80)]
    np.testing.assert_allclose(got, torch_lrs, rtol=1e-5, atol=1e-9)


@pytest.fixture(scope="module")
def tiny_setup():
    model = RefineVideoDepth(version=4, encoder="vits", features=32,
                             out_channels=(32, 32, 64, 64))
    rng = np.random.default_rng(0)
    batch = {
        "depth_anything_v2": (rng.random((2, 4, 56, 56)) * 65535
                              ).astype(np.float32),
        "depth": (rng.random((2, 4, 56, 56)) * 10 + 0.5).astype(np.float32),
        "mask": np.ones((2, 4, 56, 56), np.float32),
    }
    params = model.init(jax.random.PRNGKey(0),
                        batch["depth_anything_v2"][:1, :2])
    return model, params, batch


def test_train_step_decreases_loss_and_freezes_head(tiny_setup):
    model, params, batch = tiny_setup
    trainer = RefineTrainer(model, initial_lr=1e-3, stable_scale=1.0)
    # train_step donates the state; copy so the module-scoped fixture's
    # params stay live for later tests
    state = trainer.init_state(jax.tree.map(lambda a: np.array(a), params))
    frozen_before = jax.tree_util.tree_leaves(
        state.params["params"]["temporal_head"])[0].copy()
    losses = []
    for _ in range(5):
        state, loss_dict = trainer.train_step(state, batch)
        losses.append(float(loss_dict["total_loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    frozen_after = jax.tree_util.tree_leaves(
        state.params["params"]["temporal_head"])[0]
    np.testing.assert_array_equal(np.asarray(frozen_after), frozen_before)
    assert int(state.step) == 5


def test_preprocess_depth_minmax():
    rng = np.random.default_rng(1)
    d = rng.random((2, 3, 8, 8)).astype(np.float32) * 100 - 10
    m = np.ones_like(d)
    out = np.asarray(preprocess_depth_sequences(d, m, norm=True))
    assert out.min() >= 0 and out.max() <= 1
    nonorm = np.asarray(preprocess_depth_sequences(d, m, norm=False))
    np.testing.assert_array_equal(nonorm, np.clip(d, 0, None))


def test_rename_map():
    assert rename_with_map("head.projects.0.weight",
                           V4_RENAME_MAP) == \
        "temporal_head.projects.0.weight"
    assert rename_with_map("pretrained.blocks.0.attn.qkv.weight",
                           V4_RENAME_MAP).startswith("pretrained")


def test_v1_trainer_step():
    from vdn.models.video_depth_v1 import VideoDepthEstimationModel
    from vdn.train.trainer import V1Trainer
    model = VideoDepthEstimationModel(sequence_length=2,
                                      encoder="hiera_tiny",
                                      attention_feature_levels=(3,))
    rng = np.random.default_rng(0)
    batch = {
        "rgb": rng.random((1, 2, 64, 64, 3)).astype(np.float32),
        "depth_anything_v2": (rng.random((1, 2, 64, 64)) * 65535
                              ).astype(np.float32),
        "depth": (rng.random((1, 2, 64, 64)) * 10 + 0.5).astype(np.float32),
        "mask": np.ones((1, 2, 64, 64), np.float32),
    }
    params = model.init(jax.random.PRNGKey(0),
                        batch["depth_anything_v2"] / 65535.0, batch["rgb"])
    trainer = V1Trainer(model, initial_lr=1e-4, stable_scale=1.0)
    state = trainer.init_state(params)
    losses = []
    for _ in range(2):
        state, ld = trainer.train_step(state, batch)
        losses.append(float(ld["total_loss"]))
        assert "normal_loss" in ld
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_async_checkpoint_deterministic_resume(tiny_setup, tmp_path):
    """Interrupt-and-resume must replay the uninterrupted run exactly:
    the TrainCheckpointer restores params+optimizer+step, and the
    (seed, epoch)-keyed sampler replays the identical data stream."""
    from vdn.core.checkpoint import TrainCheckpointer
    from vdn.data.factory import WeightedSampler

    model, params, batch = tiny_setup

    class _FakeConcat:
        datasets = [list(range(6)), list(range(3))]

    sampler = WeightedSampler(_FakeConcat(), seed=7)
    # epoch-keyed sampling is a pure function of (seed, epoch)
    np.testing.assert_array_equal(sampler.sample(5, epoch=2),
                                  WeightedSampler(_FakeConcat(),
                                                  seed=7).sample(5, epoch=2))
    assert not np.array_equal(sampler.sample(5, epoch=1),
                              sampler.sample(5, epoch=2))

    def run(n_steps, state, trainer):
        losses = []
        for _ in range(n_steps):
            state, loss_dict = trainer.train_step(state, batch)
            losses.append(float(loss_dict["total_loss"]))
        return state, losses

    def fresh(p):
        return jax.tree.map(lambda a: np.array(a), p)

    trainer = RefineTrainer(model, initial_lr=1e-3, stable_scale=1.0)
    state = trainer.init_state(fresh(params))

    # uninterrupted: 2 steps
    ref_state, ref_losses = run(2, state, trainer)

    # interrupted: 1 step, async save, restore, 1 more
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    state2 = trainer.init_state(fresh(params))
    state2, first = run(1, state2, trainer)
    ckpt.save(1, {"state": state2, "epoch": 1})
    ckpt.wait()

    trainer_b = RefineTrainer(model, initial_lr=1e-3, stable_scale=1.0)
    template = {"state": trainer_b.init_state(fresh(params)), "epoch": 0}
    restored = ckpt.restore_latest(template)
    assert restored is not None and int(restored["epoch"]) == 1
    state3 = restored["state"]
    assert int(state3.step) == 1
    _, resumed = run(1, state3, trainer_b)
    ckpt.close()

    np.testing.assert_allclose(first + resumed, ref_losses,
                               rtol=1e-6, atol=1e-7)
