"""Metric-depth training: SiLog loss, poly LR, data-parallel train step.

Re-design of the reference DDP trainer (reference metric_depth/train.py:43-208,
util/loss.py:5-16, util/metric.py:4-26, util/dist_helper.py:8-41):

- NCCL DDP + SyncBatchNorm + dist.reduce become a 'data'-sharded jitted
  step (XLA inserts the gradient psum over NVLink) and host-side metric sums
- per-group LRs (encoder lr, everything else lr x 10) via optax
  multi_transform; poly decay (1 - iter/total)^0.9 stepped per iteration
- random horizontal flip augmentation is done host-side in the data loop
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

__all__ = ["silog_loss", "eval_depth", "poly_schedule",
           "MetricDepthTrainer"]


def silog_loss(pred: jnp.ndarray, target: jnp.ndarray,
               valid_mask: jnp.ndarray, lambd: float = 0.5) -> jnp.ndarray:
    """(reference metric_depth/util/loss.py:5-16)"""
    m = valid_mask.astype(jnp.float32)
    n = jnp.clip(m.sum(), 1.0, None)
    safe_pred = jnp.where(valid_mask, pred, 1.0)
    safe_t = jnp.where(valid_mask, target, 1.0)
    diff_log = (jnp.log(safe_t) - jnp.log(safe_pred)) * m
    mean_sq = jnp.sum(diff_log ** 2) / n
    mean = jnp.sum(diff_log) / n
    return jnp.sqrt(jnp.clip(mean_sq - lambd * mean ** 2, 0.0, None))


def eval_depth(pred: np.ndarray, target: np.ndarray) -> Dict[str, float]:
    """9-metric suite over flattened valid pixels
    (reference metric_depth/util/metric.py:4-26)."""
    pred = pred.astype(np.float64)
    target = target.astype(np.float64)
    thresh = np.maximum(target / pred, pred / target)
    n = pred.size
    diff = pred - target
    diff_log = np.log(pred) - np.log(target)
    return {
        "d1": float((thresh < 1.25).sum() / n),
        "d2": float((thresh < 1.25 ** 2).sum() / n),
        "d3": float((thresh < 1.25 ** 3).sum() / n),
        "abs_rel": float(np.mean(np.abs(diff) / target)),
        "sq_rel": float(np.mean(diff ** 2 / target)),
        "rmse": float(np.sqrt(np.mean(diff ** 2))),
        "rmse_log": float(np.sqrt(np.mean(diff_log ** 2))),
        "log10": float(np.mean(np.abs(np.log10(pred) - np.log10(target)))),
        "silog": float(np.sqrt(np.mean(diff_log ** 2)
                               - 0.5 * np.mean(diff_log) ** 2)),
    }


def poly_schedule(base_lr: float, total_iters: int,
                  power: float = 0.9) -> optax.Schedule:
    """(reference metric_depth/train.py:142-145)"""

    def schedule(step):
        frac = jnp.clip(step / total_iters, 0.0, 1.0)
        return base_lr * (1.0 - frac) ** power

    return schedule


class MetricDepthTrainer:
    def __init__(self, model, base_lr: float = 5e-6,
                 total_iters: int = 100_000, min_depth: float = 0.001,
                 max_depth: float = 20.0, weight_decay: float = 0.01,
                 mesh=None):
        self.model = model
        self.mesh = mesh
        self.min_depth = min_depth
        self.max_depth = max_depth
        sched = poly_schedule(base_lr, total_iters)
        sched10 = poly_schedule(base_lr * 10.0, total_iters)

        def label_fn(params):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: "encoder" if any(
                    getattr(p, "key", None) == "pretrained" for p in path)
                else "head", params)

        self.tx = optax.multi_transform(
            {"encoder": optax.adamw(sched, b1=0.9, b2=0.999,
                                    weight_decay=weight_decay),
             "head": optax.adamw(sched10, b1=0.9, b2=0.999,
                                 weight_decay=weight_decay)},
            label_fn)
        if mesh is None:
            self._train_step = jax.jit(self._train_step_impl,
                                       donate_argnums=(0, 1))
        else:
            # reference metric_depth/train.py:93-96 wraps the model in
            # NCCL DDP; here the batch rides the mesh's 'data' axis and
            # XLA inserts the gradient all-reduce.
            from vdn.train.trainer import _dp_shardings
            batch_s, rep = _dp_shardings(mesh)
            self._train_step = jax.jit(
                self._train_step_impl, donate_argnums=(0, 1),
                in_shardings=(rep, rep, batch_s, batch_s, batch_s),
                out_shardings=(rep, rep, rep))

    def init_state(self, params):
        return (params, self.tx.init(params))

    def _loss(self, params, img, depth, valid_mask):
        pred = self.model.apply(params, img)
        mask = (valid_mask > 0) & (depth >= self.min_depth) & (
            depth <= self.max_depth)
        return silog_loss(pred, depth, mask)

    def _train_step_impl(self, params, opt_state, img, depth, valid_mask):
        from vdn.train.trainer import _pin_batch
        img, depth, valid_mask = _pin_batch(self.mesh, img, depth,
                                            valid_mask)
        loss, grads = jax.value_and_grad(self._loss)(params, img, depth,
                                                     valid_mask)
        updates, opt_state = self.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def train_step(self, state, batch, rng: np.random.Generator):
        params, opt_state = state
        img = np.asarray(batch["image"], np.float32)
        depth = np.asarray(batch["depth"], np.float32)
        mask = np.asarray(batch["valid_mask"], np.float32)
        if rng.random() < 0.5:  # horizontal flip (reference :127-130)
            img = img[:, :, ::-1].copy()
            depth = depth[:, :, ::-1].copy()
            mask = mask[:, :, ::-1].copy()
        params, opt_state, loss = self._train_step(params, opt_state,
                                                   img, depth, mask)
        return (params, opt_state), float(loss)
