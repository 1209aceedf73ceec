"""Evaluation CLI: depthcrafter protocol + TPF reporting
(reference scripts/evaluate_v4.py:128-238, eval_depthcrafter/eval.py).

Usage:
  python -m vdn.cli.evaluate --dataset-config configs/config_eval.yaml \
      --datasets Sintel --encoder vitl --checkpoint ckpt.pth \
      [--model-name ours|dav2] [--double-refine]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description="vdn evaluation")
    parser.add_argument("--dataset-config", type=str, required=True)
    parser.add_argument("--datasets", nargs="+", default=["Sintel"])
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitl"])
    parser.add_argument("--model-version", type=int, default=4)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--domain", default="depth",
                        choices=["depth", "disp"])
    parser.add_argument("--seq-len", type=int, default=98)
    parser.add_argument("--double-refine", action="store_true",
                        help="run model(model(x)) like the reference "
                        "'ours' eval path (evaluate_v4.py:195-196)")
    parser.add_argument("--model-name", default="ours",
                        choices=["ours", "dav2"],
                        help="'dav2' evaluates the input depth-anything "
                        "maps directly (the reference's baseline "
                        "passthrough, evaluate_v4.py:192-196)")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from vdn.core.checkpoint import load_torch_checkpoint
    from vdn.core.convert import convert_torch_state
    from vdn.data.factory import create_datasets
    from vdn.eval.protocol import eval_sequence
    from vdn.models.presets import MODEL_CONFIGS
    from vdn.models.refine import RefineVideoDepth
    from vdn.train.trainer import V4_RENAME_MAP, rename_with_map

    cfg = MODEL_CONFIGS[args.encoder]
    dtype = jnp.bfloat16 if args.compute_dtype == "bf16" else jnp.float32
    model = RefineVideoDepth(
        version=args.model_version, encoder=cfg["encoder"],
        features=cfg["features"], out_channels=tuple(cfg["out_channels"]),
        internal_size=224 if args.model_version == 5 else None,
        compute_dtype=dtype)

    if args.checkpoint:
        params = {"params": convert_torch_state(
            load_torch_checkpoint(args.checkpoint),
            rename=lambda k: rename_with_map(k, V4_RENAME_MAP))}
    else:
        raise SystemExit("--checkpoint is required")

    fwd = jax.jit(model.apply)

    datasets = create_datasets(args.datasets, args.dataset_config, "val")
    all_metrics = []
    total_time, total_frames = 0.0, 0
    for ds in datasets:
        for i in range(len(ds)):
            item = ds[i]
            x = item["depth_anything_v2"][None].astype(np.float32)
            t0 = time.perf_counter()
            if args.model_name == "dav2":
                pred = x  # baseline: score the input depth maps as-is
            else:
                pred = fwd(params, x)
                if args.double_refine:
                    pred = fwd(params, np.asarray(pred))
            pred = np.asarray(pred)[0]
            total_time += time.perf_counter() - t0
            total_frames += pred.shape[0]
            m = eval_sequence(pred, item["depth"], seq_len=args.seq_len,
                              domain=args.domain, mask=item.get("mask"))
            all_metrics.append(m)

    avg = {k: float(np.mean([m[k] for m in all_metrics]))
           for k in all_metrics[0]}
    tpf_ms = total_time / max(total_frames, 1) * 1000
    print(json.dumps({"metrics": avg, "TPF(msec)": round(tpf_ms, 3),
                      "frames": total_frames}))


if __name__ == "__main__":
    main()
