"""Streaming throughput: vitl 518px, chunked decode, real frame fetches.

Every chunk fetches its depths to host (np.asarray), so wall time here is
an end-to-end number including device-to-host copies.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    trace = "--trace" in sys.argv
    argv = [a for a in sys.argv if not a.startswith("--")]
    chunk = int(argv[1]) if len(argv) > 1 else 8
    n_frames = int(argv[2]) if len(argv) > 2 else 64
    from vdn.models.video_depth_anything import build_video_depth_anything
    from vdn.pipelines.stream import VideoDepthStreamPipeline

    model = build_video_depth_anything("vitl", compute_dtype=jnp.bfloat16)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 2, 56, 56, 3), jnp.float32))
    pipe = VideoDepthStreamPipeline(model, params, input_size=518)

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(n_frames, 518, 518, 3),
                          dtype=np.uint8)

    # warmup: first frame + one full chunk + one tail-size compile
    pipe.infer_video_depth_chunk(list(frames[:1 + chunk]))
    done = 1 + chunk

    if trace:
        # capture ONE warmed chunk dispatch for tools/parse_trace.py
        # (op-level breakdown of the chunk step)
        with jax.profiler.trace("profiles/stream"):
            out = pipe.infer_video_depth_chunk(
                list(frames[done:done + chunk]))
            done += chunk
            np.asarray(out[-1])
        print("trace written to profiles/stream")

    t0 = time.perf_counter()
    count = 0
    while done < n_frames:
        k = min(chunk, n_frames - done)
        out = pipe.infer_video_depth_chunk(list(frames[done:done + k]))
        assert len(out) == k and out[0].shape == (518, 518)
        done += k
        count += k
    dt = time.perf_counter() - t0
    print(f"chunk={chunk}: {count} frames in {dt:.2f}s -> "
          f"{count / dt:.2f} fps (per-frame {1e3 * dt / count:.1f} ms)")


if __name__ == "__main__":
    main()
