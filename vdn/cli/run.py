"""Single-image depth CLI (reference run.py:1-70).

Usage:
  python -m vdn.cli.run --img-path img_or_dir --encoder vitl \
      --checkpoint checkpoints/depth_anything_v2_vitl.pth --outdir vis_depth
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def build_pipeline(encoder: str, checkpoint: str, compute_dtype: str = "fp32"):
    import jax.numpy as jnp
    from vdn.core.checkpoint import load_torch_checkpoint
    from vdn.core.convert import convert_torch_state
    from vdn.models.depth_anything_v2 import build_depth_anything_v2
    from vdn.pipelines.infer_image import DepthAnythingV2Pipeline

    dtype = jnp.bfloat16 if compute_dtype == "bf16" else jnp.float32
    model = build_depth_anything_v2(encoder, compute_dtype=dtype)
    state = load_torch_checkpoint(checkpoint)
    params = {"params": convert_torch_state(state)}
    return DepthAnythingV2Pipeline(model, params)


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    import cv2
    parser = argparse.ArgumentParser(description="Depth Anything V2 (vdn)")
    parser.add_argument("--img-path", type=str, required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--outdir", type=str, default="./vis_depth")
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--pred-only", action="store_true")
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    args = parser.parse_args(argv)

    from vdn.utils.video_io import colorize_depth

    pipe = build_pipeline(args.encoder, args.checkpoint, args.compute_dtype)

    if os.path.isfile(args.img_path):
        if args.img_path.endswith("txt"):
            with open(args.img_path) as f:
                filenames = f.read().splitlines()
        else:
            filenames = [args.img_path]
    else:
        filenames = sorted(glob.glob(os.path.join(args.img_path, "**/*"),
                                     recursive=True))

    os.makedirs(args.outdir, exist_ok=True)
    for k, filename in enumerate(filenames):
        print(f"Progress {k + 1}/{len(filenames)}: {filename}")
        raw = cv2.imread(filename)
        if raw is None:
            continue
        depth = pipe.infer_image(raw, args.input_size)
        vis = colorize_depth(depth, cmap="Spectral_r",
                             grayscale=args.grayscale)
        out_name = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(filename))[0] + ".png")
        if args.pred_only:
            cv2.imwrite(out_name, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
        else:
            margin = np.ones((raw.shape[0], 50, 3), np.uint8) * 255
            combined = cv2.hconcat(
                [raw, margin, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR)])
            cv2.imwrite(out_name, combined)


if __name__ == "__main__":
    main()
