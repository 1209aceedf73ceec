"""Profile the flagship clip forward on the accelerator.

Splits per-window time into encoder vs temporal-DPT head, prints an XLA
cost-analysis FLOP estimate and the achieved FLOP rate, and (with --trace)
captures a jax.profiler trace to profiles/ for op-level breakdown.

Each quantity is measured as bench.py does: a two-point slope of K
iterations chained inside ONE lax.while_loop executable.  Cross-check any
number here against the trace's XLA-module wall (parse_trace.py)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def slope_timed(apply_fn, params, x, k_small=2, k_large=6, reps=3):
    """Per-iteration seconds via an in-executable chained while_loop,
    two-point slope (cancels dispatch/fetch overhead)."""

    @jax.jit
    def run(params, x, k):
        def body(c):
            i, x, acc = c
            out = apply_fn(params, x)
            # consume EVERY output leaf — depending on only one would let
            # XLA dead-code-eliminate the rest of the computation
            bump = jnp.tanh(sum(
                jnp.mean(leaf) for leaf in jax.tree.leaves(out))) * 1e-3
            return i + 1, x * (1.0 + bump), acc + bump

        _, _, acc = jax.lax.while_loop(
            lambda c: c[0] < k, body, (jnp.int32(0), x, jnp.float32(0.0)))
        return acc

    float(run(params, x, jnp.int32(1)))  # compile + warm

    def best(k):
        t = float("inf")
        for _ in range(reps):
            start = time.perf_counter()
            float(run(params, x, jnp.int32(k)))
            t = min(t, time.perf_counter() - start)
        return t

    return (best(k_large) - best(k_small)) / (k_large - k_small)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--encoder", default="vitl")
    ap.add_argument("--cached", action="store_true",
                    help="profile the steady-state cached window (22 new "
                         "frames + gathered KEYFRAMES seed features — the "
                         "default pipeline path; trace goes to "
                         "profiles/clip_cached)")
    args = ap.parse_args()

    from vdn.models.video_depth_anything import build_video_depth_anything

    model = build_video_depth_anything(args.encoder,
                                       compute_dtype=jnp.bfloat16)
    rng = jax.random.PRNGKey(0)
    params = jax.jit(model.init)(rng, jnp.zeros((1, 2, 56, 56, 3),
                                                jnp.float32))
    x = jax.random.normal(jax.random.PRNGKey(1),
                          (1, args.frames, args.size, args.size, 3),
                          jnp.float32)

    if args.cached:
        # steady-state pipeline window: the features output feeds the next
        # iteration's gather, so chain through (x, feats) jointly
        from vdn.pipelines.infer_video import OVERLAP, make_cached_window_fns
        full_fn, cached_raw = make_cached_window_fns(model)
        _, feats0 = full_fn(params, x)
        x = x[:, OVERLAP:]

        def apply_fn(p, carry):
            x_new, feats = carry
            depth, feats = cached_raw(p, x_new, feats)
            return depth, feats

        def slope_timed_carry(k_small=2, k_large=6, reps=3):
            @jax.jit
            def run(params, x_new, feats, k):
                def body(c):
                    i, x, feats, acc = c
                    depth, feats = cached_raw(params, x, feats)
                    bump = jnp.tanh(jnp.mean(depth)) * 1e-3
                    acc = acc + bump + 0.0 * jnp.mean(
                        feats[-1][1].astype(jnp.float32))
                    return i + 1, x * (1.0 + bump), feats, acc

                _, _, _, acc = jax.lax.while_loop(
                    lambda c: c[0] < k, body,
                    (jnp.int32(0), x_new, feats, jnp.float32(0.0)))
                return acc

            float(run(params, x, feats0, jnp.int32(1)))

            def best(k):
                t = float("inf")
                for _ in range(reps):
                    start = time.perf_counter()
                    float(run(params, x, feats0, jnp.int32(k)))
                    t = min(t, time.perf_counter() - start)
                return t

            return (best(k_large) - best(k_small)) / (k_large - k_small)

        fwd = jax.jit(lambda p, xn, f: cached_raw(p, xn, f))
        lowered = fwd.lower(params, x, feats0)
        compiled = lowered.compile()
        cost = compiled.cost_analysis()
        flops = cost.get("flops", float("nan")) if cost else float("nan")

        t_full = slope_timed_carry()
        t_enc = slope_timed(
            lambda p, x: model.apply(p, x, method=model.forward_features),
            params, x)  # 22 NEW frames only — the steady-state encode cost

        fps = args.frames / t_full
        report = {
            "full_ms": round(t_full * 1e3, 2),
            "encoder_new_frames_ms": round(t_enc * 1e3, 2),
            "head_plus_gather_ms": round((t_full - t_enc) * 1e3, 2),
            "fps": round(fps, 2),
            "xla_flops_per_window": flops,
            "tflops_per_sec": round(flops / t_full / 1e12, 1),
            "device_kind": jax.devices()[0].device_kind,
        }
        print("PROFILE " + json.dumps(report))

        if args.trace:
            trace_dir = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "profiles",
                "clip_cached")
            with jax.profiler.trace(trace_dir):
                depth, feats = fwd(params, x, feats0)
                x = x.at[0, 0, 0, 0, 0].add(
                    float(jnp.mean(depth[0, 0])) * 1e-6)
                depth, feats = fwd(params, x, feats)
                float(jnp.mean(depth[0, 0]))
            print("TRACE_DIR " + trace_dir)
        return

    fwd = jax.jit(model.apply)

    lowered = fwd.lower(params, x)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    flops = cost.get("flops", float("nan")) if cost else float("nan")

    t_full = slope_timed(model.apply, params, x)
    t_enc = slope_timed(
        lambda p, x: model.apply(p, x, method=model.forward_features),
        params, x)

    fps = args.frames / t_full
    report = {
        "full_ms": round(t_full * 1e3, 2),
        "encoder_ms": round(t_enc * 1e3, 2),
        "head_ms": round((t_full - t_enc) * 1e3, 2),
        "fps": round(fps, 2),
        "xla_flops_per_window": flops,
        "tflops_per_sec": round(flops / t_full / 1e12, 1),
        "device_kind": jax.devices()[0].device_kind,
    }
    print("PROFILE " + json.dumps(report))

    if args.trace:
        trace_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "profiles",
            "clip")
        with jax.profiler.trace(trace_dir):
            out = fwd(params, x)
            # complete the first dispatch before a second distinct one
            x = x.at[0, 0, 0, 0, 0].add(
                float(jnp.mean(out[0, 0])) * 1e-6)
            out = fwd(params, x)
            float(jnp.mean(out[0, 0]))
        print("TRACE_DIR " + trace_dir)


if __name__ == "__main__":
    main()
