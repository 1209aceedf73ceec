"""Metric (absolute-scale) single-image depth CLI
(reference metric_depth/run.py:1-80).

Usage:
  python -m vdn.cli.run_metric --img-path img_or_dir --encoder vitl \
      --load-from checkpoints/depth_anything_v2_metric_hypersim_vitl.pth \
      --max-depth 20
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def build_metric_pipeline(encoder: str, checkpoint: str,
                          max_depth: float = 20.0,
                          compute_dtype: str = "fp32"):
    """Returns ``infer(raw_bgr, input_size) -> depth [H, W] meters``.

    Same host protocol as the relative pipeline (cv2 lower-bound resize
    to a multiple of 14, ImageNet norm, align-corners bilinear back to
    source resolution — reference depth_anything_v2.py:57-92); the model
    is the sigmoid-bounded metric head x max_depth."""
    import jax
    import jax.numpy as jnp

    from vdn.core.checkpoint import load_torch_checkpoint
    from vdn.core.convert import convert_torch_state
    from vdn.models.metric_depth import MetricDepthAnythingV2
    from vdn.models.presets import MODEL_CONFIGS
    from vdn.ops.resize import resize2d
    from vdn.pipelines.transform import image2tensor_bgr

    cfg = MODEL_CONFIGS[encoder]
    dtype = jnp.bfloat16 if compute_dtype == "bf16" else jnp.float32
    model = MetricDepthAnythingV2(
        encoder=cfg["encoder"], features=cfg["features"],
        out_channels=tuple(cfg["out_channels"]), max_depth=max_depth,
        compute_dtype=dtype)
    params = {"params": convert_torch_state(
        load_torch_checkpoint(checkpoint))}
    fwd = jax.jit(model.apply)

    def infer(raw_bgr: np.ndarray, input_size: int = 518) -> np.ndarray:
        x, (h, w) = image2tensor_bgr(raw_bgr, input_size)
        depth = fwd(params, x)
        out = resize2d(np.asarray(depth)[..., None], (h, w),
                       "bilinear", align_corners=True)
        return np.asarray(out)[0, :, :, 0]

    return infer


def _list_images(img_path: str):
    if os.path.isfile(img_path):
        if img_path.endswith("txt"):
            with open(img_path) as f:
                return f.read().splitlines()
        return [img_path]
    return sorted(glob.glob(os.path.join(img_path, "**/*"), recursive=True))


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    import cv2
    parser = argparse.ArgumentParser(
        description="Depth Anything V2 Metric Depth Estimation (vdn)")
    parser.add_argument("--img-path", type=str, required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--outdir", type=str, default="./vis_depth")
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--load-from", "--checkpoint", dest="load_from",
                        type=str, required=True)
    parser.add_argument("--max-depth", type=float, default=20)
    parser.add_argument("--save-numpy", action="store_true",
                        help="save the raw metric depth as .npy")
    parser.add_argument("--pred-only", action="store_true")
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    args = parser.parse_args(argv)

    from vdn.utils.video_io import colorize_depth

    infer = build_metric_pipeline(args.encoder, args.load_from,
                                  args.max_depth, args.compute_dtype)
    filenames = _list_images(args.img_path)
    os.makedirs(args.outdir, exist_ok=True)
    for k, filename in enumerate(filenames):
        print(f"Progress {k + 1}/{len(filenames)}: {filename}")
        raw = cv2.imread(filename)
        if raw is None:
            continue
        depth = infer(raw, args.input_size)
        stem = os.path.splitext(os.path.basename(filename))[0]
        if args.save_numpy:
            np.save(os.path.join(args.outdir, stem + "_raw_depth_meter.npy"),
                    depth)
        # metric maps color near=small (the reference does not invert)
        vis = colorize_depth(depth, cmap="Spectral", grayscale=args.grayscale)
        out_name = os.path.join(args.outdir, stem + ".png")
        if args.pred_only:
            cv2.imwrite(out_name, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
        else:
            margin = np.ones((raw.shape[0], 50, 3), np.uint8) * 255
            combined = cv2.hconcat(
                [raw, margin, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR)])
            cv2.imwrite(out_name, combined)


if __name__ == "__main__":
    main()
