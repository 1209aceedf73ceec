"""DA-2K relative-depth benchmark CLI (reference DA-2K.md protocol).

Usage:
  python -m vdn.cli.eval_da2k --benchmark-root /path/to/DA-2K \
      --encoder vitl --checkpoint depth_anything_v2_vitl.pth \
      [--scene-type indoor]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    from vdn.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description="DA-2K eval (vdn)")
    parser.add_argument("--benchmark-root", required=True)
    parser.add_argument("--encoder", default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--input-size", type=int, default=518)
    parser.add_argument("--scene-type", default=None)
    parser.add_argument("--compute-dtype", default="bf16",
                        choices=["fp32", "bf16"])
    args = parser.parse_args(argv)

    from vdn.cli.run import build_pipeline
    from vdn.eval.da2k import evaluate_da2k

    pipe = build_pipeline(args.encoder, args.checkpoint,
                          args.compute_dtype)

    def infer(raw_bgr):
        pipe.clear_memory()  # DA-2K is independent single images
        return pipe.infer_image(raw_bgr, args.input_size)

    out = evaluate_da2k(args.benchmark_root, infer, args.scene_type)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
