"""Video depth CLI (reference run_video.py).

Usage:
  python -m vdn.cli.run_video --video-path in.mp4 --encoder vitl \
      --checkpoint checkpoints/video_depth_anything_vitl.pth \
      [--streaming] [--max-res 1280] [--target-fps -1]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description="Video Depth (vdn)")
    parser.add_argument("--video-path", type=str, required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--outdir", type=str, default="./vis_video_depth")
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitl"])
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--max-res", type=int, default=1280)
    parser.add_argument("--target-fps", type=float, default=-1)
    parser.add_argument("--max-len", type=int, default=-1)
    parser.add_argument("--streaming", action="store_true",
                        help="bounded-memory per-frame decode")
    parser.add_argument("--chunk-size", type=int, default=8,
                        help="frames per streaming dispatch (1 = reference "
                             "per-frame granularity)")
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    args = parser.parse_args(argv)

    import jax.numpy as jnp
    from vdn.core.checkpoint import load_torch_checkpoint
    from vdn.core.convert import convert_torch_state
    from vdn.models.video_depth_anything import build_video_depth_anything
    from vdn.pipelines.infer_video import infer_video_depth
    from vdn.pipelines.stream import VideoDepthStreamPipeline
    from vdn.utils.video_io import read_video_frames, save_video

    dtype = jnp.bfloat16 if args.compute_dtype == "bf16" else jnp.float32
    model = build_video_depth_anything(args.encoder, compute_dtype=dtype)
    params = {"params": convert_torch_state(
        load_torch_checkpoint(args.checkpoint))}

    frames, fps = read_video_frames(args.video_path, args.max_len,
                                    args.target_fps, args.max_res)
    print(f"{len(frames)} frames @ {fps:.2f} fps")

    if args.streaming:
        pipe = VideoDepthStreamPipeline(model, params, args.input_size)
        k = max(1, args.chunk_size)
        pending, out = [], []
        for start in range(0, len(frames), k):
            chunk = pipe.infer_video_depth_chunk(
                list(frames[start:start + k]), fetch=False)
            # fetch the previous chunk while this one computes
            out.extend(np.asarray(d) for d in pending)
            pending = chunk
        out.extend(np.asarray(d) for d in pending)
        depths = np.stack(out)
    else:
        depths, fps = infer_video_depth(model, params, frames, fps,
                                        args.input_size)

    os.makedirs(args.outdir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.video_path))[0]
    save_video(frames, os.path.join(args.outdir, f"{base}_src.mp4"),
               fps=fps)
    save_video(depths, os.path.join(args.outdir, f"{base}_vis.mp4"),
               fps=fps, is_depths=True, grayscale=args.grayscale)
    np.save(os.path.join(args.outdir, f"{base}_depths.npy"), depths)


if __name__ == "__main__":
    main()
