"""Metric-depth training CLI (reference metric_depth/train.py:43-208 +
dist_train.sh).

Single- or multi-host: the reference's 8-GPU NCCL DDP becomes the 'data'
mesh axis (XLA gradient psum); on pods call with --distributed to run
jax.distributed.initialize first.

Usage:
  python -m vdn.cli.train_metric --dataset hypersim \
      --train-list splits/hypersim_train.txt --val-list splits/hypersim_val.txt \
      --encoder vitl --max-depth 20 --epochs 40
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description="vdn metric-depth training")
    parser.add_argument("--dataset", default="hypersim",
                        choices=["hypersim", "vkitti2"])
    parser.add_argument("--train-list", required=True)
    parser.add_argument("--val-list", default=None)
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--img-size", type=int, default=518)
    parser.add_argument("--min-depth", type=float, default=0.001)
    parser.add_argument("--max-depth", type=float, default=20.0)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--lr", type=float, default=5e-6)
    parser.add_argument("--from-pretrained", default=None,
                        help="relative-depth .pth to warm-start the encoder"
                        " (keeps only pretrained.* keys like the reference,"
                        " metric_depth/train.py:91)")
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--log-dir", default="./logs")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--use-wandb", action="store_true")
    parser.add_argument("--resume-run", action="store_true",
                        help="re-attach logging to the tracked run named "
                        "--run-name (or the latest) incl. its wandb id")
    parser.add_argument("--debug-nans", action="store_true",
                        help="numeric sanitizer: jax_debug_nans + finite-"
                        "loss guard per step")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    args = parser.parse_args(argv)

    if args.distributed:
        from vdn.parallel.launch import initialize_distributed
        initialize_distributed()

    import jax
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    import jax.numpy as jnp
    from vdn.core.checkpoint import (load_torch_checkpoint, save_pytree)
    from vdn.core.convert import convert_torch_state
    from vdn.data.factory import BatchLoader
    from vdn.data.metric_datasets import Hypersim, VKITTI2
    from vdn.models.metric_depth import MetricDepthAnythingV2
    from vdn.models.presets import MODEL_CONFIGS
    from vdn.parallel.launch import is_primary
    from vdn.train.metric_depth import MetricDepthTrainer, eval_depth
    from vdn.utils.logging import MetricWriter

    cfg = MODEL_CONFIGS[args.encoder]
    dtype = jnp.bfloat16 if args.compute_dtype == "bf16" else jnp.float32
    model = MetricDepthAnythingV2(
        encoder=cfg["encoder"], features=cfg["features"],
        out_channels=tuple(cfg["out_channels"]), max_depth=args.max_depth,
        compute_dtype=dtype)

    cls = Hypersim if args.dataset == "hypersim" else VKITTI2
    size = (args.img_size, args.img_size)
    train_ds = cls(args.train_list, "train", size, seed=args.seed)
    val_ds = cls(args.val_list, "val", size) if args.val_list else None
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               seed=args.seed)

    sample = train_ds[0]
    init_x = sample["image"][None].astype(np.float32)
    if args.from_pretrained:
        state = load_torch_checkpoint(args.from_pretrained)
        # keep only the encoder, like the reference warm start
        params = {"params": convert_torch_state(
            state, rename=lambda k: k if k.startswith("pretrained") else
            None)}
        init = model.init(jax.random.PRNGKey(args.seed), init_x)
        init["params"].update(params["params"])
        params = init
    else:
        params = model.init(jax.random.PRNGKey(args.seed), init_x)

    total_iters = args.epochs * len(train_loader)
    trainer = MetricDepthTrainer(model, base_lr=args.lr,
                                 total_iters=max(total_iters, 1),
                                 min_depth=args.min_depth,
                                 max_depth=args.max_depth)
    state = trainer.init_state(params)
    logger = MetricWriter(args.log_dir, project="vdn-metric",
                          run_name=args.run_name, use_wandb=args.use_wandb,
                          resume=args.resume_run) \
        if is_primary() else None
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    fwd = jax.jit(model.apply)

    for epoch in range(args.epochs):
        total = 0.0
        count = 0
        for batch in train_loader:
            state, loss = trainer.train_step(state, batch, rng)
            if args.debug_nans and not np.isfinite(float(loss)):
                raise FloatingPointError(
                    f"non-finite loss {float(loss)} at epoch {epoch} "
                    f"step {count} (--debug-nans)")
            total += loss
            count += 1
        if logger:
            logger.add_metrics({"train/loss": total / max(count, 1),
                                "epoch": epoch + 1})

        if val_ds is not None:
            sums = {}
            n = 0
            for i in range(len(val_ds)):
                s = val_ds[i]
                pred = np.asarray(fwd(state[0], s["image"][None]))[0]
                if pred.shape != s["depth"].shape:
                    # predictions are at network res; GT stays at original
                    # res in val mode (reference metric_depth/train.py:166+)
                    from vdn.ops.resize import resize2d
                    pred = np.asarray(resize2d(
                        pred[None, :, :, None], s["depth"].shape,
                        "bilinear", align_corners=True))[0, :, :, 0]
                valid = (s["valid_mask"] & (s["depth"] >= args.min_depth)
                         & (s["depth"] <= args.max_depth))
                if not valid.any():
                    continue
                m = eval_depth(pred[valid], s["depth"][valid])
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + v
                n += 1
            if logger and n:
                logger.add_metrics({f"val/{k}": v / n
                                    for k, v in sums.items()})
        if logger:
            logger.send_log(step=epoch + 1)
            save_pytree(os.path.join(
                args.checkpoint_dir,
                f"{logger.run_name}_metric_{args.encoder}"
                f"_epoch_{epoch + 1}"), state[0])
    if logger:
        logger.finish()


if __name__ == "__main__":
    main()
