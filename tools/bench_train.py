"""Training-step throughput for the canonical v4 refinement trainer.

Same methodology as bench.py: K train steps run inside ONE jitted
lax.while_loop (state threads through, so steps serialize), timed at two
K points; the slope is the per-step cost.  Reports steps/sec, frames/sec and achieved TFLOP/s (XLA
cost-analysis FLOPs for fwd+bwd+adamw).

Usage: python tools/bench_train.py [--batch 2] [--frames 8] [--size 518]
       [--encoder vitl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def bench_metric(args):
    """Metric-depth trainer (reference metric_depth/train.py semantics):
    single-image DA2 + sigmoid head, SiLog loss, poly LR, 10x head LR."""
    from vdn.models.metric_depth import MetricDepthAnythingV2
    from vdn.train.metric_depth import MetricDepthTrainer

    model = MetricDepthAnythingV2(encoder=args.encoder, max_depth=20.0,
                                  compute_dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    b, s = args.batch, args.size
    img = jnp.asarray(rng.random((b, s, s, 3)).astype(np.float32))
    depth = jnp.asarray((rng.random((b, s, s)) * 19 + 0.5
                         ).astype(np.float32))
    mask = jnp.ones((b, s, s), jnp.float32)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3), jnp.float32))
    trainer = MetricDepthTrainer(model)
    params, opt_state = trainer.init_state(params)

    @jax.jit
    def run(params, opt_state, k):
        def body(c):
            i, p, o, acc = c
            p, o, loss = trainer._train_step_impl(p, o, img, depth, mask)
            return i + 1, p, o, acc + loss

        _, _, _, acc = jax.lax.while_loop(
            lambda c: c[0] < k, body,
            (jnp.int32(0), params, opt_state, jnp.float32(0.0)))
        return acc

    single = jax.jit(trainer._train_step_impl)
    cost = single.lower(params, opt_state, img, depth,
                        mask).compile().cost_analysis()
    flops = cost.get("flops", float("nan")) if cost else float("nan")

    float(run(params, opt_state, jnp.int32(1)))

    def best(k):
        v = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(run(params, opt_state, jnp.int32(k)))
            v = min(v, time.perf_counter() - t0)
        return v

    k0, k1 = args.k
    per_step = (best(k1) - best(k0)) / (k1 - k0)
    print(json.dumps({
        "metric": f"train_metric_{args.encoder}_{s}px_b{b}_step_ms",
        "step_ms": round(per_step * 1e3, 1),
        "steps_per_sec": round(1.0 / per_step, 3),
        "images_per_sec": round(b / per_step, 2),
        "xla_flops_per_step": flops,
        "tflops_per_sec": round(flops / per_step / 1e12, 1),
        "device_kind": jax.devices()[0].device_kind,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--encoder", default="vitl")
    ap.add_argument("--k", type=int, nargs=2, default=(1, 4))
    ap.add_argument("--model", default="refine",
                    choices=("refine", "metric"),
                    help="refine: canonical v4 trainer; metric: the "
                         "metric-depth (SiLog) trainer")
    ap.add_argument("--trace", action="store_true",
                    help="capture one warmed step to profiles/train")
    ap.add_argument("--ssim", action="store_true",
                    help="enable ssim_loss_scale=1.0 (the reference's "
                         "optional MS-SSIM term, loss/loss.py:296-323) — "
                         "the guard that the separable-conv SSIM blur "
                         "does not regress the step")
    args = ap.parse_args()

    if args.model == "metric":
        if args.ssim:
            ap.error("--ssim only applies to --model refine (the metric "
                     "trainer has no SSIM term)")
        return bench_metric(args)

    from vdn.models.refine import RefineVideoDepth
    from vdn.train.trainer import RefineTrainer

    # remat default ON; VDN_TRAIN_REMAT=0 A/Bs paying the activations to
    # skip the encoder recompute
    remat = os.environ.get("VDN_TRAIN_REMAT", "1") != "0"
    model = RefineVideoDepth(version=4, encoder=args.encoder,
                             compute_dtype=jnp.bfloat16, remat=remat)
    rng = np.random.default_rng(0)
    b, t, s = args.batch, args.frames, args.size
    batch = {
        "depth_anything_v2": (rng.random((b, t, s, s)) * 65535
                              ).astype(np.float32),
        "depth": (rng.random((b, t, s, s)) * 10 + 0.5).astype(np.float32),
        "mask": np.ones((b, t, s, s), np.float32),
    }
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 56, 56), jnp.float32))
    trainer = RefineTrainer(model, initial_lr=1e-5, stable_scale=10.0,
                            ssim_loss_scale=1.0 if args.ssim else 0.0)
    state = trainer.init_state(params)
    from vdn.train.trainer import preprocess_depth_sequences
    input_depths = preprocess_depth_sequences(
        jnp.asarray(batch["depth_anything_v2"]),
        jnp.asarray(batch["mask"]), norm=False)
    gt = jnp.asarray(batch["depth"])
    masks = jnp.asarray(batch["mask"])

    @jax.jit
    def run(state, input_depths, gt, masks, k):
        def body(c):
            i, st, acc = c
            st, metrics = trainer._train_step_impl(st, input_depths, gt,
                                                   masks)
            return i + 1, st, acc + metrics["total_loss"]

        _, _, acc = jax.lax.while_loop(
            lambda c: c[0] < k, body,
            (jnp.int32(0), state, jnp.float32(0.0)))
        return acc

    if args.trace:
        # ONE warmed step dispatch for tools/parse_trace.py.  Donate
        # the state, so two dispatches do not hold three full fp32
        # optimizer states.
        single_d = jax.jit(trainer._train_step_impl, donate_argnums=(0,))
        state, _ = single_d(state, input_depths, gt, masks)
        with jax.profiler.trace("profiles/train"):
            state, metrics = single_d(state, input_depths, gt, masks)
            float(metrics["total_loss"])
        print("trace written to profiles/train")
        return

    # cost analysis of a single train step for the TFLOP/s denominator
    single = jax.jit(trainer._train_step_impl)
    cost = single.lower(state, input_depths, gt,
                        masks).compile().cost_analysis()
    flops = cost.get("flops", float("nan")) if cost else float("nan")

    float(run(state, input_depths, gt, masks, jnp.int32(1)))  # compile

    def best(k):
        v = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(run(state, input_depths, gt, masks, jnp.int32(k)))
            v = min(v, time.perf_counter() - t0)
        return v

    k0, k1 = args.k
    per_step = (best(k1) - best(k0)) / (k1 - k0)
    suffix = "_ssim" if args.ssim else ""
    print(json.dumps({
        "metric": f"train_v4_{args.encoder}_{s}px_b{b}t{t}_step_ms{suffix}",
        "step_ms": round(per_step * 1e3, 1),
        "steps_per_sec": round(1.0 / per_step, 3),
        "frames_per_sec": round(b * t / per_step, 2),
        "xla_flops_per_step": flops,
        "tflops_per_sec": round(flops / per_step / 1e12, 1),
        "device_kind": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
