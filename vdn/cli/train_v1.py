"""v1 research-model training CLI (reference scripts/train.py:413-530).

Depth+normal objective over the dual-Hiera model, with per-epoch
validation (reference ``validate``, train.py:376-410), orbax async
checkpointing, and deterministic resume — the same harness surface as
`vdn.cli.train` (the v4 trainer).

Usage:
  python -m vdn.cli.train_v1 --dataset-config configs/train_dataset_config.yaml \
      --datasets Sintel --encoder hiera_base_224 [--epochs 200]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description="vdn v1 depth+normal "
                                     "training")
    parser.add_argument("--config", type=str, default=None,
                        help="master experiment config (the reference "
                        "configs/config.yaml switchboard, made live): "
                        "its values become the defaults below, explicit "
                        "flags still win, and its datasets: section "
                        "drives --datasets/--dataset-config")
    parser.add_argument("--dataset-config", type=str, default=None)
    parser.add_argument("--datasets", nargs="+", default=None)
    parser.add_argument("--encoder", default="hiera_base_224",
                        help="hub-MAE names (hiera_*_224) or SAM2 hieradet "
                        "names (hiera_tiny, ...)")
    parser.add_argument("--sequence-length", type=int, default=16)
    parser.add_argument("--attention-levels", default="2,3",
                        help="comma-separated pyramid levels that get the "
                        "(temporal-spatial)x2 attention stacks "
                        "(reference video_depth_head_v2_sangyu.py:179)")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=6)
    parser.add_argument("--initial-lr", type=float, default=1e-4)
    parser.add_argument("--final-lr", type=float, default=1e-7)
    parser.add_argument("--alpha", type=float, default=0.0)
    parser.add_argument("--stable-scale", type=float, default=0.0)
    parser.add_argument("--normal-loss-scale", type=float, default=0.0)
    parser.add_argument("--use-residual", action="store_true", default=True)
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint "
                        "(params+optimizer+epoch + deterministic data "
                        "restart), like vdn.cli.train")
    parser.add_argument("--log-dir", default="./logs")
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--use-wandb", action="store_true")
    parser.add_argument("--val-interval", type=int, default=1)
    parser.add_argument("--save-interval", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--debug-nans", action="store_true",
                        help="numeric sanitizer: jax_debug_nans + finite-"
                        "loss guard per step")
    from vdn.cli._common import parse_with_master_config
    args = parse_with_master_config(parser, argv, family="v1")

    import jax
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    from vdn.core.checkpoint import TrainCheckpointer
    from vdn.data.factory import (BatchLoader, ConcatDataset,
                                  WeightedSampler, create_datasets)
    from vdn.models.video_depth_v1 import VideoDepthEstimationModel
    from vdn.train.trainer import V1Trainer
    from vdn.utils.logging import MetricWriter

    levels = tuple(int(v) for v in args.attention_levels.split(","))
    model = VideoDepthEstimationModel(
        sequence_length=args.sequence_length, encoder=args.encoder,
        attention_feature_levels=levels,
        use_residual=args.use_residual, use_final_relu=True)

    train_sets = create_datasets(args.datasets, args.dataset_config,
                                 "train", args.seed)
    val_sets = create_datasets(args.datasets, args.dataset_config, "val",
                               args.seed)
    train_concat = ConcatDataset(train_sets)
    sampler = WeightedSampler(train_concat, seed=args.seed)
    train_loader = BatchLoader(train_concat, args.batch_size,
                               sampler=sampler)
    val_loader = BatchLoader(ConcatDataset(val_sets), args.batch_size,
                             shuffle=False)

    sample = train_concat[0]
    init_depth = sample["depth_anything_v2"][None, :2].astype(
        np.float32) / 65535.0
    init_rgb = sample["rgb"][None, :2].astype(np.float32)
    params = model.init(jax.random.PRNGKey(args.seed), init_depth,
                        init_rgb)

    trainer = V1Trainer(
        model, initial_lr=args.initial_lr, final_lr=args.final_lr,
        alpha=args.alpha, stable_scale=args.stable_scale,
        normal_loss_scale=args.normal_loss_scale)
    state = trainer.init_state(params)

    logger = MetricWriter(args.log_dir, run_name=args.run_name,
                          use_wandb=args.use_wandb, resume=args.resume)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    ckpt = TrainCheckpointer(os.path.join(
        args.checkpoint_dir, "video_depth_normal_v1"))
    start_epoch = 0
    if args.resume:
        restored = ckpt.restore_latest({"state": state, "epoch": 0})
        if restored is not None:
            state = restored["state"]
            start_epoch = int(restored["epoch"])
            print(f"resumed from epoch {start_epoch}")

    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        sums, count = {}, 0
        for batch in train_loader:
            state, loss_dict = trainer.train_step(state, _to_batch(batch))
            total = float(loss_dict["total_loss"])
            if args.debug_nans and not np.isfinite(total):
                raise FloatingPointError(
                    f"non-finite loss {total} at epoch {epoch} "
                    f"step {count} (--debug-nans)")
            for k, v in loss_dict.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        logger.add_metrics({f"training/{k}": v / max(count, 1)
                            for k, v in sums.items()})

        if (epoch + 1) % args.val_interval == 0:
            vsums, vcount = {}, 0
            for batch in val_loader:
                ld = trainer.eval_step(state, _to_batch(batch))
                for k, v in ld.items():
                    vsums[k] = vsums.get(k, 0.0) + float(v)
                vcount += 1
            logger.add_metrics({f"validation/{k}": v / max(vcount, 1)
                                for k, v in vsums.items()})
        logger.add_metrics({"epoch": epoch + 1})
        logger.send_log(step=epoch + 1)

        if (epoch + 1) % args.save_interval == 0:
            ckpt.save(epoch + 1, {"state": state, "epoch": epoch + 1})
    ckpt.close()
    logger.finish()


def _to_batch(batch):
    return {
        "rgb": batch["rgb"].astype(np.float32),
        "depth_anything_v2": batch["depth_anything_v2"].astype(np.float32),
        "depth": batch["depth"].astype(np.float32),
        "mask": batch["mask"].astype(np.float32),
    }


if __name__ == "__main__":
    main()
