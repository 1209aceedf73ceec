"""Refinement training CLI (v4 semantics, reference scripts/train_v4.py).

Usage:
  python -m vdn.cli.train --dataset-config configs/train_dataset_config.yaml \
      --datasets Sintel --encoder vitl [--from-pretrained ckpt.pth] \
      [--epochs 10] [--batch-size 2]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description="vdn refinement training")
    parser.add_argument("--config", type=str, default=None,
                        help="master experiment config (the reference "
                        "configs/config.yaml switchboard, made live): "
                        "its values become the defaults below, explicit "
                        "flags still win, and its datasets: section "
                        "drives --datasets/--dataset-config")
    parser.add_argument("--dataset-config", type=str, default=None)
    parser.add_argument("--datasets", nargs="+", default=None)
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitl"])
    parser.add_argument("--model-version", type=int, default=4)
    parser.add_argument("--from-pretrained", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--initial-lr", type=float, default=1e-5)
    parser.add_argument("--final-lr", type=float, default=0.0)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--stable-scale", type=float, default=10.0)
    parser.add_argument("--ssim-loss-scale", type=float, default=0.0)
    parser.add_argument("--freeze-temporal-head", type=int, default=None,
                        help="1/0; default: frozen for v4/v5 (reference "
                        "train_v4.py:493), trainable for v2/v3")
    parser.add_argument("--use-residual", action="store_true", default=True)
    parser.add_argument("--input-normal", action="store_true", default=True)
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                        "--checkpoint-dir (params+optimizer+epoch, with a "
                        "deterministic data-stream restart)")
    parser.add_argument("--log-dir", default="./logs")
    parser.add_argument("--run-name", default=None,
                        help="experiment name; with --resume, re-attaches "
                        "to this tracked run (and its wandb id) instead of "
                        "allocating a new E### entry")
    parser.add_argument("--use-wandb", action="store_true")
    parser.add_argument("--debug-nans", action="store_true",
                        help="numeric sanitizer: jax_debug_nans (raises at "
                        "the op that produced the first NaN) + a finite-"
                        "loss guard per step")
    parser.add_argument("--val-interval", type=int, default=1)
    parser.add_argument("--save-interval", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    from vdn.cli._common import parse_with_master_config
    args = parse_with_master_config(parser, argv, family="refine")

    import jax
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    import jax.numpy as jnp
    from vdn.core.checkpoint import (TrainCheckpointer,
                                     load_torch_checkpoint)
    from vdn.core.convert import convert_torch_state
    from vdn.data.factory import (BatchLoader, ConcatDataset,
                                  WeightedSampler, create_datasets)
    from vdn.models.presets import MODEL_CONFIGS
    from vdn.models.refine import RefineVideoDepth
    from vdn.train.trainer import (RefineTrainer, V4_RENAME_MAP,
                                   rename_with_map)
    from vdn.utils.logging import MetricWriter

    cfg = MODEL_CONFIGS[args.encoder]
    dtype = jnp.bfloat16 if args.compute_dtype == "bf16" else jnp.float32
    model = RefineVideoDepth(
        version=args.model_version, encoder=cfg["encoder"],
        features=cfg["features"], out_channels=tuple(cfg["out_channels"]),
        use_residual=args.use_residual, input_normal=args.input_normal,
        internal_size=224 if args.model_version == 5 else None,
        compute_dtype=dtype)

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
    init_x = sample["depth_anything_v2"][None, :2].astype(np.float32)
    if args.from_pretrained:
        state = load_torch_checkpoint(args.from_pretrained)
        params = {"params": convert_torch_state(
            state, rename=lambda k: rename_with_map(k, V4_RENAME_MAP))}
    else:
        params = model.init(jax.random.PRNGKey(args.seed), init_x)

    freeze = (args.model_version >= 4 if args.freeze_temporal_head is None
              else bool(args.freeze_temporal_head))
    trainer = RefineTrainer(
        model, initial_lr=args.initial_lr, final_lr=args.final_lr,
        alpha=args.alpha, stable_scale=args.stable_scale,
        ssim_loss_scale=args.ssim_loss_scale,
        freeze_temporal_head=freeze)
    state = trainer.init_state(params)

    logger = MetricWriter(args.log_dir, run_name=args.run_name,
                          use_wandb=args.use_wandb, resume=args.resume)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    ckpt = TrainCheckpointer(os.path.join(
        args.checkpoint_dir, f"refine_v{args.model_version}"))
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
            # async: serialization overlaps the next epoch's compute
            ckpt.save(epoch + 1, {"state": state, "epoch": epoch + 1})
    ckpt.close()
    logger.finish()


def _to_batch(batch):
    return {
        "depth_anything_v2": batch["depth_anything_v2"].astype(np.float32),
        "depth": batch["depth"].astype(np.float32),
        "mask": batch["mask"].astype(np.float32),
    }


if __name__ == "__main__":
    main()
