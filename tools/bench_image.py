"""Single-image memory-bank serving bench (BASELINE config 1).

The reference's ``run.py`` loop (reference run.py:35-57): every frame runs
the DINOv2 encoder, MemoryAttention over the up-to-6-entry memory bank
(6 x 1369 tokens cross-attended per layer, reference
depth_anything_v2/memory_block.py:92-125), the DPT head, then encodes the
(feature, depth) pair into a new bank entry (MemoryEncoder).  This bench
times that FULL steady-state stateful step — forward-with-memory +
encode_memory + ring-buffer update — with bench.py's two-point
while_loop slope method.

Usage: python tools/bench_image.py [--encoder vits|vitl] [--trace]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

SIZE = 518
K_SMALL, K_LARGE = 2, 12
REPS = 5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", default="vits", choices=("vits", "vitb",
                                                          "vitl"))
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--trace", action="store_true",
                    help="capture ONE warmed step to profiles/image")
    args = ap.parse_args()

    from vdn.models.depth_anything_v2 import build_depth_anything_v2
    from vdn.nn.memory import init_memory_state, update_memory_state

    model = build_depth_anything_v2(args.encoder,
                                    compute_dtype=jnp.bfloat16)
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.PRNGKey(1),
                          (1, args.size, args.size, 3), jnp.float32)

    def init_all(m, x):
        # touch forward AND the memory encoder so the param tree is
        # complete (encode_memory owns the MemoryEncoder params)
        depth, feat = m(x, None)
        return m.encode_memory(feat, depth)

    params = jax.jit(
        lambda r, x: model.init(r, x, method=init_all))(
            rng, jnp.zeros((1, 56, 56, 3), jnp.float32))

    # seed the bank to steady state (count saturates at capacity=6)
    depth0, mem_feat = jax.jit(lambda p, x: model.apply(p, x, None))(
        params, x)
    state = init_memory_state(1, mem_feat.shape[1], mem_feat.shape[2],
                              capacity=model.max_memory_length)

    @jax.jit
    def fill(params, state, mem_feat, depth):
        entry = model.apply(params, mem_feat, depth,
                            method=model.encode_memory)
        return update_memory_state(state, *entry)

    for _ in range(model.max_memory_length):
        state = fill(params, state, mem_feat, depth0)

    @jax.jit
    def run(params, x, state, k):
        """k chained steady-state frames: each step's input is perturbed
        by the previous depth AND carries the updated memory state, so no
        step can be deduplicated, reordered, or dead-code-eliminated."""
        def cond(c):
            return c[0] < k

        def body(c):
            i, x, state, acc = c
            depth, mem_feat = model.apply(params, x, state)
            entry = model.apply(params, mem_feat, depth,
                                method=model.encode_memory)
            state = update_memory_state(state, *entry)
            bump = jnp.tanh(jnp.mean(depth)) * 1e-3
            # consume every state leaf (carried) + the depth output
            return i + 1, x * (1.0 + bump), state, acc + jnp.mean(depth)

        _, _, _, acc = jax.lax.while_loop(
            cond, body, (jnp.int32(0), x, state, jnp.float32(0.0)))
        return acc

    float(run(params, x, state, jnp.int32(1)))  # warmup/compile

    if args.trace:
        with jax.profiler.trace("profiles/image"):
            float(run(params, x, state, jnp.int32(1)))
        print("trace written to profiles/image")
        return

    # cost analysis of one stateful step (forward-with-memory +
    # encode_memory + ring update) for the achieved FLOP rate
    def one_step(params, x, state):
        depth, mem_feat = model.apply(params, x, state)
        entry = model.apply(params, mem_feat, depth,
                            method=model.encode_memory)
        return depth, update_memory_state(state, *entry)

    single = jax.jit(one_step)
    cost = single.lower(params, x, state).compile().cost_analysis()
    flops = cost.get("flops", float("nan")) if cost else float("nan")

    def timed(k):
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            float(run(params, x, state, jnp.int32(k)))
            best = min(best, time.perf_counter() - t0)
        return best

    t_s, t_l = timed(K_SMALL), timed(K_LARGE)
    per_frame = (t_l - t_s) / (K_LARGE - K_SMALL)
    print(f"image[{args.encoder}@{args.size}] memory-bank stateful step on "
          f"{jax.devices()[0].device_kind}: "
          f"{1e3 * per_frame:.2f} ms/frame -> {1.0 / per_frame:.1f} fps | "
          f"{flops / 1e9:.1f} GFLOP -> {flops / per_frame / 1e12:.1f} TF/s")


if __name__ == "__main__":
    main()
