"""v1 dual-Hiera depth+normal forward bench (BASELINE config 5).

The reference's v1 research model (reference models/video_depth_model.py:
62-119): normal_vector on the input depth, two Hiera encoders (RGB +
[depth, nx, ny]), summed feature pyramids, the sangyu spatiotemporal head,
and the [-dx, -dy, 1] normal rebuild.  Reference operating point:
hiera_small_224 at 224px, sequence_length 8 (scripts/train.py:494-505).

Slope-timed with the two-point while_loop method (see bench.py docstring).

Usage: python tools/bench_v1.py [--encoder hiera_small_224] [--frames 8]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

K_SMALL, K_LARGE = 2, 12
REPS = 5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", default="hiera_small_224")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--trace", action="store_true",
                    help="capture ONE warmed step to profiles/v1")
    args = ap.parse_args()

    from vdn.models.video_depth_v1 import VideoDepthEstimationModel

    model = VideoDepthEstimationModel(sequence_length=args.frames,
                                      encoder=args.encoder)
    s, hw = args.frames, args.size
    depth = jax.random.uniform(jax.random.PRNGKey(0), (1, s, hw, hw))
    img = jax.random.normal(jax.random.PRNGKey(1), (1, s, hw, hw, 3))
    params = jax.jit(model.init)(jax.random.PRNGKey(2), depth, img)

    @jax.jit
    def run(params, depth, img, k):
        def cond(c):
            return c[0] < k

        def body(c):
            i, depth, img, acc = c
            d, n = model.apply(params, depth, img)
            bump = jnp.tanh(jnp.mean(d)) * 1e-3
            # consume BOTH outputs (depth + normal) or XLA DCEs the
            # normal branch of the head
            acc = acc + jnp.mean(d) + jnp.mean(n)
            return i + 1, depth * (1.0 + bump), img * (1.0 + bump), acc

        _, _, _, acc = jax.lax.while_loop(
            cond, body, (jnp.int32(0), depth, img, jnp.float32(0.0)))
        return acc

    float(run(params, depth, img, jnp.int32(1)))  # warmup/compile

    if args.trace:
        with jax.profiler.trace("profiles/v1"):
            float(run(params, depth, img, jnp.int32(1)))
        print("trace written to profiles/v1")
        return

    # cost analysis of one forward for the achieved FLOP rate
    single = jax.jit(model.apply)
    cost = single.lower(params, depth, img).compile().cost_analysis()
    flops = cost.get("flops", float("nan")) if cost else float("nan")

    def timed(k):
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            float(run(params, depth, img, jnp.int32(k)))
            best = min(best, time.perf_counter() - t0)
        return best

    t_s, t_l = timed(K_SMALL), timed(K_LARGE)
    per_fwd = (t_l - t_s) / (K_LARGE - K_SMALL)
    fpf = args.frames / per_fwd
    print(f"v1[{args.encoder}@{args.size} S={args.frames}] depth+normal "
          f"forward on {jax.devices()[0].device_kind}: "
          f"{1e3 * per_fwd:.2f} ms/clip -> {fpf:.1f} frames/s | "
          f"{flops / 1e9:.1f} GFLOP -> {flops / per_fwd / 1e12:.1f} TF/s")


if __name__ == "__main__":
    main()
