"""SAM2 serving benchmarks (reference sam2/benchmark.py:20-92).

The reference ships a video-predictor FPS harness (bf16 autocast, warm-up
+ per-frame timing over propagate_in_video); this is the counterpart
for all three SAM2 serving surfaces, measured with bench.py's two-point
while_loop slope:

- ``image``: encode_image + point-prompt predict (the Sam2ImagePredictor
  set_image/predict unit, reference sam2_image_predictor.py:430-466).
- ``video``: the steady-state per-frame tracking step — encode_image_raw,
  memory attention over 7 mask memories (1 conditioning + 6 rolling,
  4096 tokens each) + 16 object pointers (64 tokens), SAM heads, and
  encode_memory, with the memory bank and pointer ring rolled on device
  exactly like Sam2VideoPredictor._track_one assembles them
  (vdn/pipelines/sam2_video.py:215-282).
- ``amg``: one 64-point batched multimask decode (the device unit of
  Sam2AutomaticMaskGenerator.generate; a 32x32-grid sweep is 16 such
  batches).

Usage: python tools/bench_sam2.py [--component image|video|amg|all]
       [--trunk hiera_base_plus] [--dtype bf16|fp32] [--trace]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

REPS = 4


def _timed(run, args, k, reps=REPS):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(*args, jnp.int32(k)))
        best = min(best, time.perf_counter() - t0)
    return best


def _slope(run, args, ks):
    float(run(*args, jnp.int32(1)))  # compile + warm
    t0, t1 = _timed(run, args, ks[0]), _timed(run, args, ks[1])
    return (t1 - t0) / (ks[1] - ks[0])


def _report(name, per_iter, flops, extra=None):
    rec = {
        "metric": f"sam2_{name}_ms",
        "ms": round(per_iter * 1e3, 2),
        "per_sec": round(1.0 / per_iter, 2),
        "device_kind": jax.devices()[0].device_kind,
    }
    if flops == flops:  # not NaN
        rec["xla_flops"] = flops
        rec["tflops_per_sec"] = round(flops / per_iter / 1e12, 1)
    if extra:
        rec.update(extra)
    print(json.dumps(rec))


def _cost_flops(jitted, *args):
    cost = jitted.lower(*args).compile().cost_analysis()
    return cost.get("flops", float("nan")) if cost else float("nan")


def bench_image(model, params, args):
    """encode + single-point predict, chained through the mask output."""
    s = model.image_size
    x = jax.random.normal(jax.random.PRNGKey(1), (1, s, s, 3), jnp.float32)
    pc = jnp.asarray([[[s * 0.4, s * 0.6]]], jnp.float32)
    pl = jnp.ones((1, 1), jnp.float32)

    def step(params, x, pc, pl):
        feats = model.apply(params, x, method=model.encode_image)
        low, high, ious, ptr, logit = model.apply(
            params, feats, point_coords=pc, point_labels=pl,
            multimask_output=True, apply_obj_gating=False,
            method=model.predict)
        return low, ious

    @jax.jit
    def run(params, x, pc, pl, k):
        def body(c):
            i, x, acc = c
            low, ious = step(params, x, pc, pl)
            bump = jnp.tanh(jnp.mean(low)) * 1e-3
            return (i + 1, x * (1.0 + bump),
                    acc + jnp.mean(low) + jnp.sum(ious))

        _, _, acc = jax.lax.while_loop(
            lambda c: c[0] < k, body, (jnp.int32(0), x, jnp.float32(0.0)))
        return acc

    if args.trace:
        float(run(params, x, pc, pl, jnp.int32(1)))
        with jax.profiler.trace("profiles/sam2_image"):
            float(run(params, x, pc, pl, jnp.int32(1)))
        print("trace written to profiles/sam2_image")
        return
    flops = _cost_flops(jax.jit(step), params, x, pc, pl)
    per = _slope(run, (params, x, pc, pl), (1, 6))
    _report(f"image_{args.trunk}_{s}", per, flops,
            {"unit": "ms/image (encode + point predict)"})


def _steady_state_memory(model, params, feats, high, logits, ptr):
    """Build the fixed steady-state memory_pos and the initial rolling
    banks, mirroring Sam2VideoPredictor._assemble_memory ordering: the
    conditioning frame at t_pos 0, then 6 tracked frames at t_pos 1..6,
    then 16 object pointers (t_diffs 0..15)."""
    mem_feat, mem_pos = model.apply(params, feats, high, logits,
                                    method=model.encode_memory)
    b, hh, ww, c = mem_feat.shape
    n = hh * ww
    poss = [model.apply(params, mem_pos, t,
                        method=model.maskmem_pos_with_tpos
                        ).reshape(b, n, c)
            for t in range(model.num_maskmem)]
    n_ptr = model.max_obj_ptrs_in_encoder
    t_diffs = jnp.arange(n_ptr, dtype=jnp.float32)
    ptrs0 = jnp.tile(ptr, (n_ptr, 1))
    tokens, tok_pos = model.apply(params, ptrs0, t_diffs,
                                  method=model.obj_ptr_tokens)
    memory_pos = jnp.concatenate(poss + [tok_pos[None]], axis=1)
    cond_mem = mem_feat.reshape(b, n, c)          # fixed t_pos-0 block
    roll_mem = jnp.tile(cond_mem, (1, model.num_maskmem - 1, 1))
    return memory_pos, cond_mem, roll_mem, ptrs0, t_diffs, n


def bench_video(model, params, args):
    """Steady-state tracking step: encode, memory-conditioned predict,
    memory write, ring update (reference propagate_in_video per-frame
    unit, sam2/benchmark.py:74-87)."""
    s = model.image_size
    x = jax.random.normal(jax.random.PRNGKey(2), (1, s, s, 3), jnp.float32)

    seed = jax.jit(lambda p, x: model.apply(p, x))
    low0, high0, ious0, ptr0, logit0 = seed(params, x)
    feats0 = jax.jit(
        lambda p, x: model.apply(p, x, method=model.encode_image_raw))(
            params, x)
    memory_pos, cond_mem, roll_mem, ptrs, t_diffs, n = \
        _steady_state_memory(model, params, feats0, high0[:, :1], logit0,
                             ptr0)
    n_tok = int(model.max_obj_ptrs_in_encoder * model.d_model
                // model.mem_dim)

    def step(params, x, roll_mem, ptrs):
        feats = model.apply(params, x, method=model.encode_image_raw)
        tokens, _ = model.apply(params, ptrs, t_diffs,
                                method=model.obj_ptr_tokens)
        memory = jnp.concatenate([cond_mem, roll_mem, tokens[None]],
                                 axis=1)
        cond = model.apply(params, feats, memory, memory_pos, n_tok,
                           method=model.condition_features)
        low, high, ious, obj_ptr, obj_logits = model.apply(
            params, cond, multimask_output=True, method=model.predict)
        best = jnp.argmax(ious[0])
        high_best = jax.lax.dynamic_slice_in_dim(high, best, 1, axis=1)
        mem_feat, _ = model.apply(params, feats, high_best, obj_logits,
                                  method=model.encode_memory)
        roll_mem = jnp.concatenate(
            [roll_mem[:, n:], mem_feat.reshape(1, n, -1)], axis=1)
        ptrs = jnp.concatenate([ptrs[1:], obj_ptr], axis=0)
        return low, roll_mem, ptrs

    @jax.jit
    def run(params, x, roll_mem, ptrs, k):
        def body(c):
            i, x, rm, pt, acc = c
            low, rm, pt = step(params, x, rm, pt)
            bump = jnp.tanh(jnp.mean(low)) * 1e-3
            return i + 1, x * (1.0 + bump), rm, pt, acc + jnp.mean(low)

        _, _, _, _, acc = jax.lax.while_loop(
            lambda c: c[0] < k, body,
            (jnp.int32(0), x, roll_mem, ptrs, jnp.float32(0.0)))
        return acc

    if args.trace:
        float(run(params, x, roll_mem, ptrs, jnp.int32(1)))
        with jax.profiler.trace("profiles/sam2_video"):
            float(run(params, x, roll_mem, ptrs, jnp.int32(1)))
        print("trace written to profiles/sam2_video")
        return
    flops = _cost_flops(jax.jit(step), params, x, roll_mem, ptrs)
    per = _slope(run, (params, x, roll_mem, ptrs), (1, 6))
    _report(f"video_track_{args.trunk}_{s}", per, flops,
            {"unit": "ms/frame (steady-state tracking step)",
             "fps": round(1.0 / per, 2)})


def bench_amg(model, params, args):
    """One 64-point batched multimask decode over cached features (the
    AMG device unit; a full 32x32 grid sweep = 16 batches)."""
    s = model.image_size
    x = jax.random.normal(jax.random.PRNGKey(3), (1, s, s, 3), jnp.float32)
    feats = jax.jit(
        lambda p, x: model.apply(p, x, method=model.encode_image))(
            params, x)
    p_batch = 64
    pc = jax.random.uniform(jax.random.PRNGKey(4), (p_batch, 1, 2),
                            jnp.float32, 0, s)
    pl = jnp.ones((p_batch, 1), jnp.float32)

    def step(params, feats, pc, pl):
        featsb = {k: jnp.broadcast_to(v, (p_batch,) + v.shape[1:])
                  for k, v in feats.items()}
        low, high, ious, ptr, logit = model.apply(
            params, featsb, point_coords=pc, point_labels=pl,
            multimask_output=True, apply_obj_gating=False,
            method=model.predict)
        return low, ious

    @jax.jit
    def run(params, feats, pc, pl, k):
        def body(c):
            i, pc, acc = c
            low, ious = step(params, feats, pc, pl)
            bump = jnp.tanh(jnp.mean(low)) * 1e-3
            return (i + 1, pc * (1.0 + bump),
                    acc + jnp.mean(low) + jnp.sum(ious))

        _, _, acc = jax.lax.while_loop(
            lambda c: c[0] < k, body, (jnp.int32(0), pc, jnp.float32(0.0)))
        return acc

    if args.trace:
        float(run(params, feats, pc, pl, jnp.int32(1)))
        with jax.profiler.trace("profiles/sam2_amg"):
            float(run(params, feats, pc, pl, jnp.int32(1)))
        print("trace written to profiles/sam2_amg")
        return
    flops = _cost_flops(jax.jit(step), params, feats, pc, pl)
    per = _slope(run, (params, feats, pc, pl), (1, 6))
    _report(f"amg_batch64_{args.trunk}_{s}", per, flops,
            {"unit": "ms/64-point batch (32x32 sweep = 16 batches)",
             "points_per_sec": round(p_batch / per, 1)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--component", default="all",
                    choices=("image", "video", "amg", "all"))
    ap.add_argument("--trunk", default="hiera_base_plus")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"),
                    help="bf16 mirrors the reference benchmark's autocast")
    ap.add_argument("--trace", action="store_true",
                    help="capture ONE warmed step per component to "
                         "profiles/sam2_*")
    args = ap.parse_args()

    from vdn.models.sam2_video import Sam2VideoModel

    cd = jnp.bfloat16 if args.dtype == "bf16" else None
    model = Sam2VideoModel(trunk_variant=args.trunk, compute_dtype=cd)
    s = model.image_size
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3), jnp.float32))

    if args.component in ("image", "all"):
        bench_image(model, params, args)
    if args.component in ("video", "all"):
        bench_video(model, params, args)
    if args.component in ("amg", "all"):
        bench_amg(model, params, args)


if __name__ == "__main__":
    main()
