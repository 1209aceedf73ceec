"""Smoke check of vdn on a GPU: the video-depth main path at vitl/518.

    python chip_smoke.py              one card, phases 0-4 below
    python chip_smoke.py --chips 4    four cards: data-parallel train step
                                      and context-parallel clip forward,
                                      each against the same work on one
                                      card, in float32

Weights are random, made from ``--seed``; compute is bf16 as served.
Phases (each prints its own lines and raises on any failed check):

0. environment: card name and power limit, JAX devices, the attention
   implementation chosen at each call site; fails off the GPU.
1. attention at real widths (ViT self-attention, memory-bank
   cross-attention, temporal attention): cuDNN and XLA forward and
   gradient against a float32 reference, and their times.
2. clip video depth through ``infer_video_depth`` on a 54-frame 480x640
   clip, plus one window's encoder features and head pre-activation
   against the same params in float32.
3. streaming: a seed frame and 8-frame chunks through the stream pipeline.
4. training: three RefineTrainer v4 steps at B=2, T=8.

The last line of standard output is one JSON object with ``ok`` and the
device.  Any failure exits non-zero before that line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OPTIONAL = ("flax", "cv2", "yaml", "orbax", "torch")

# Stated tolerances.  bf16 keeps 8 significant bits (unit roundoff
# 2^-9 = 2e-3).  Attention rounds q/k/v, the probabilities and the output
# once each, so the relative Frobenius error of its output against a
# float32 reference on the same bf16-rounded inputs is about 2^-9: 2.1e-3
# to 2.4e-3 forward and 2.9e-3 to 3.4e-3 for the gradients, both
# implementations, every call site, on an H100.  Logits and softmax in
# bf16 instead of float32 read 4.7e-3 to 5.8e-3 forward there, so the
# forward tolerance sits between; a wrong mask, scale or layout gives
# order 1.
ATTN_FWD_TOL = 3.5e-3
ATTN_GRAD_TOL = 5e-3
# Whole model, bf16 vs float32 ("highest") on the same params and window.
# With random weights the head's pre-activation output is negative at all
# but a few pixels, so the ReLU'd depth is a thin tail just above zero and
# its relative error mostly measures which tail pixels cross zero (PERF.md,
# Findings).  The checks read the two tensors that carry the whole signal:
# the last encoder features and the head's pre-activation output.  Their
# tolerances sit above the readings on two seeds at vitl/518 on an H100.
FEATURE_TOL = 1.5e-2
PREACT_TOL = 3e-2
# The output island accumulates in float32, so its outputs fall on the
# bf16 grid about once in 2^16; an island run in bf16 puts all of them
# there.
BF16_GRID_TOL = 1e-2
# Four cards against one run in float32 at "highest" precision, where
# they differ only in the order of their sums: on four virtual CPU devices
# the clip forward agrees to 1e-6 and the train step's gradients to
# 1.2e-3.  A fault in the sharding or the collectives gives order 1.
CP_TOL = 1e-4
DP_LOSS_TOL = 1e-3
DP_GRAD_TOL = 3e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> float:
    """||got - ref|| / ||ref||; a reference of zeros proves nothing."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if not np.any(ref):
        raise AssertionError("reference is all zeros")
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def aligned_rel_l1(got, ref) -> float:
    """mean|s*got + t - ref| / mean|ref| with (s, t) fit by least squares."""
    g = np.asarray(got, np.float64).reshape(-1)
    r = np.asarray(ref, np.float64).reshape(-1)
    a = np.stack([g, np.ones_like(g)], 1)
    (s, t), *_ = np.linalg.lstsq(a, r, rcond=None)
    return float(np.mean(np.abs(s * g + t - r)) / max(np.mean(np.abs(r)),
                                                        1e-30))


def check(name: str, value: float, tol: float) -> None:
    ok = np.isfinite(value) and value <= tol
    log(f"  {name}: {value:.3e} (tolerance {tol:.2g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value} exceeds {tol}")


def timed(fn, *args, reps: int = 10) -> float:
    """Median seconds of ``fn(*args)`` after one warm-up call, host clock
    around ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def peak_gib(device) -> float:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", float("nan")) / 2 ** 30


# ---------------------------------------------------------------- phase 0

def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def attention_cases(full: bool = True):
    """The attention call sites of the served models, at their widths:
    (name, q shape [B, Tq, H, D], kv length, masked)."""
    if not full:
        return [("vit_self", (2, 40, 2, 8), 40, False),
                ("memory_bank", (1, 9, 2, 8), 54, True),
                ("temporal", (6, 8, 2, 8), 8, False)]
    return [
        ("vit_self_518x518", (32, 1370, 16, 64), 1370, False),
        ("vit_self_518x686", (32, 1814, 16, 64), 1814, False),
        ("memory_bank", (1, 1369, 16, 64), 6 * 1369, True),
        ("temporal_c1024", (1369, 32, 8, 128), 32, False),
        ("temporal_c256", (5476, 32, 8, 32), 32, False),
    ]


def report_dispatch(cases, platform: str, dtype) -> dict:
    from vdn.ops.attention import choose_implementation
    chosen = {}
    for name, qs, tk, masked in cases:
        chosen[name] = choose_implementation(platform, dtype, qs[-1], qs[1],
                                             tk, masked)
        log(f"  dispatch {name} q={qs} tk={tk} masked={masked}: "
            f"{chosen[name]}")
    return chosen


def check_imports() -> None:
    """The served path imports none of the optional packages."""
    import vdn.models.video_depth_anything  # noqa: F401
    import vdn.pipelines.infer_video  # noqa: F401
    import vdn.pipelines.stream  # noqa: F401
    import vdn.train.trainer  # noqa: F401
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in OPTIONAL)
    log(f"  optional packages imported by the main path: {loaded or 'none'}")
    if loaded:
        raise AssertionError(f"main path imported {loaded}")


# ---------------------------------------------------------------- phase 1

def phase_attention(cases, dtype, impls, reps: int = 5, seed: int = 0):
    """Forward and gradient of each implementation against a float32
    reference (``"highest"`` precision, XLA), and the times of each."""
    import jax
    import jax.numpy as jnp

    from vdn.ops.attention import dot_product_attention

    results = {}
    for ci, (name, qs, tk, masked) in enumerate(cases):
        b, tq, h, d = qs
        keys = jax.random.split(jax.random.PRNGKey(seed + ci), 4)
        q = jax.random.normal(keys[0], qs, jnp.float32).astype(dtype)
        k = jax.random.normal(keys[1], (b, tk, h, d), jnp.float32
                              ).astype(dtype)
        v = jax.random.normal(keys[2], (b, tk, h, d), jnp.float32
                              ).astype(dtype)
        ct = jax.random.normal(keys[3], qs, jnp.float32)
        # the oldest memory slots not yet written
        mask = (jnp.arange(tk) >= tk // 3)[None, None, None, :] \
            if masked else None

        def fwd_fn(impl):  # arrays are arguments, never folded constants
            return jax.jit(lambda q, k, v, mask: dot_product_attention(
                q, k, v, mask=mask, implementation=impl))

        def grad_fn(impl):
            def loss(q, k, v, mask, ct):
                out = dot_product_attention(q, k, v, mask=mask,
                                            implementation=impl)
                return jnp.sum(out.astype(jnp.float32) * ct)
            return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))

        with jax.default_matmul_precision("highest"):
            q32, k32, v32 = (a.astype(jnp.float32) for a in (q, k, v))
            ref = jax.device_get(fwd_fn("xla")(q32, k32, v32, mask))
            ref_g = jax.device_get(grad_fn("xla")(q32, k32, v32, mask, ct))
        del q32, k32, v32
        results[name] = {}
        for impl in impls:
            fwd = fwd_fn(impl)
            log(f"  {name} [{impl}]")
            check(f"{name} {impl} forward rel err",
                  rel_err(fwd(q, k, v, mask), ref), ATTN_FWD_TOL)
            rec = {"fwd_ms": 1e3 * timed(fwd, q, k, v, mask, reps=reps)}
            # cuDNN's masked backward takes even sequence lengths only
            if not (impl == "cudnn" and masked and (tq % 2 or tk % 2)):
                grad = grad_fn(impl)
                for nm, g, r in zip("qkv", grad(q, k, v, mask, ct), ref_g):
                    check(f"{name} {impl} d{nm} rel err", rel_err(g, r),
                          ATTN_GRAD_TOL)
                rec["fwd_bwd_ms"] = 1e3 * timed(grad, q, k, v, mask, ct,
                                                reps=reps)
            log(f"  {name} [{impl}] times: " + ", ".join(
                f"{key} {val:.3f}" for key, val in rec.items()))
            results[name][impl] = rec
        del q, k, v, ref, ref_g
    return results


# ---------------------------------------------------------------- phase 2

def synthetic_clip(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """[n, h, w, 3] uint8: smooth moving shapes plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    frames = []
    for t in range(n):
        c = [0.5 + 0.4 * np.sin(xx / (17 + 9 * i) + yy / (23 + 5 * i)
                                + phase[i] + 0.15 * t) for i in range(3)]
        img = np.stack(c, -1)
        img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
        frames.append(np.clip(img * 255, 0, 255).astype(np.uint8))
    return np.stack(frames)


def build_clip_model(encoder: str, dtype, seed: int, **kw):
    import jax
    import jax.numpy as jnp

    from vdn.models.video_depth_anything import build_video_depth_anything
    model = build_video_depth_anything(encoder, compute_dtype=dtype, **kw)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 2, 56, 56, 3), jnp.float32))
    return model, params


def window_stages(m, x):
    """``apply`` method: the last encoder features [B*T, N, C] and the
    head's pre-activation output [B*T, H, W] of one window."""
    t, h, w = x.shape[1:4]
    feats = m.forward_features(x)
    r1, r2, l3, l4 = m.head.decode_pre(feats, h // 14, w // 14)
    p3, _ = m.head.decode_temporal(l3, l4, tuple(r2.shape[-3:-1]), t)
    pre = m.head.decode_post(p3, r1, r2, (h // 14 * 14, w // 14 * 14),
                             final_act=lambda z: z)
    return feats[-1][0], pre[..., 0]


def window_stages_fn(model):
    import jax
    return jax.jit(lambda p, x: model.apply(p, x, method=window_stages))


def bf16_grid_share(x) -> float:
    """Share of the nonzero values of ``x`` that bf16 holds exactly."""
    import jax.numpy as jnp
    x = np.asarray(x, np.float32).ravel()
    x = x[x != 0]
    if not x.size:
        raise AssertionError("no nonzero values")
    return float(np.mean(np.asarray(x.astype(jnp.bfloat16), np.float32)
                         == x))


def phase_clip(model, params, frames: np.ndarray, input_size: int,
               reps: int = 5) -> dict:
    """Serve the clip through ``infer_video_depth`` (cold, then warm),
    time the steady cached window, and compare one window's encoder
    features and head pre-activation with the same params in float32."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from vdn.pipelines.infer_video import (INFER_LEN, OVERLAP,
                                           infer_video_depth,
                                           make_cached_window_fns)
    from vdn.pipelines.transform import (adjust_input_size_for_ratio,
                                         preprocess_frames)

    n, h, w = frames.shape[:3]
    t0 = time.perf_counter()
    depths, _ = infer_video_depth(model, params, frames, 30.0, input_size)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    depths, _ = infer_video_depth(model, params, frames, 30.0, input_size)
    warm = time.perf_counter() - t0
    if depths.shape != (n, h, w) or not np.isfinite(depths).all():
        raise AssertionError(f"clip depths {depths.shape} not finite/shape")
    log(f"  clip {n}x{h}x{w}: first call {cold:.2f} s, second call "
        f"{warm:.2f} s ({n / warm:.2f} frames/s end to end; each call "
        f"traces its window functions again), depth range "
        f"[{depths.min():.4g}, {depths.max():.4g}]")

    size = adjust_input_size_for_ratio(h, w, input_size)
    prep = timed(lambda f: preprocess_frames(f, size),
                 frames[:INFER_LEN], reps=reps) / INFER_LEN
    x = preprocess_frames(frames[:INFER_LEN], size)[None]
    full_fn, cached_fn = make_cached_window_fns(model)
    t0 = time.perf_counter()
    full_fn.lower(params, x)
    trace = time.perf_counter() - t0
    depth, feats = full_fn(params, x)
    window = 1e3 * timed(cached_fn, params, x[:, OVERLAP:], feats, reps=reps)
    log(f"  window input {tuple(x.shape)}; steady cached window "
        f"{window:.1f} ms ({(INFER_LEN - OVERLAP) / window * 1e3:.1f} new "
        f"frames/s); preprocess {1e3 * prep:.2f} ms/frame (host to device "
        f"copy included); trace+lower of the full window {trace:.2f} s")

    model32 = dataclasses.replace(model, compute_dtype=jnp.float32)
    feat, pre = window_stages_fn(model)(params, x)
    with jax.default_matmul_precision("highest"):
        feat32, pre32 = window_stages_fn(model32)(params, x)
    ref = np.maximum(np.asarray(pre32), 0)  # the float32 depth
    log(f"  float32 depth: {np.mean(ref > 0):.2%} of pixels positive; "
        f"aligned rel L1 of the bf16 depth {aligned_rel_l1(depth, ref):.3e}"
        f" (read, not checked)")
    res = {"feature_err": rel_err(feat, feat32),
           "preact_err": rel_err(pre, pre32),
           "bf16_grid_share": bf16_grid_share(pre)}
    check("window encoder features bf16 vs fp32 (rel err)",
          res["feature_err"], FEATURE_TOL)
    check("window head pre-activation bf16 vs fp32 (rel err)",
          res["preact_err"], PREACT_TOL)
    check("share of island outputs on the bf16 grid",
          res["bf16_grid_share"], BF16_GRID_TOL)
    return {"cold_s": cold, "warm_s": warm, "window_ms": window,
            "prep_ms_per_frame": 1e3 * prep, "trace_s": trace, **res}


# ---------------------------------------------------------------- phase 3

def phase_stream(model, params, frames: np.ndarray, input_size: int,
                 chunk: int) -> dict:
    """Seed frame, then 8-frame chunks; the first chunk compiles."""
    from vdn.pipelines.stream import VideoDepthStreamPipeline

    pipe = VideoDepthStreamPipeline(model, params, input_size)
    h, w = frames.shape[1:3]
    out = pipe.infer_video_depth_chunk([frames[0]])
    times = []
    for start in range(1, len(frames) - chunk + 1, chunk):
        t0 = time.perf_counter()
        out += pipe.infer_video_depth_chunk(list(frames[start:start + chunk]))
        times.append(time.perf_counter() - t0)
    depths = np.stack(out)
    if depths.shape[1:] != (h, w) or not np.isfinite(depths).all():
        raise AssertionError(f"stream depths {depths.shape} not finite")
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    log(f"  stream {len(depths)} frames: first chunk {times[0]:.2f} s "
        f"(compiles), steady {1e3 * steady / chunk:.1f} ms/frame "
        f"(chunk {chunk})")
    return {"ms_per_frame": 1e3 * steady / chunk}


# ---------------------------------------------------------------- phase 4

def train_batch(b: int, t: int, size: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "depth_anything_v2": (rng.random((b, t, size, size)) * 65535
                              ).astype(np.float32),
        "depth": (rng.random((b, t, size, size)) * 10 + 0.5
                  ).astype(np.float32),
        "mask": np.ones((b, t, size, size), np.float32),
    }


def build_trainer(encoder: str, dtype, seed: int, mesh=None,
                  remat: bool = True, **model_kw):
    import jax
    import jax.numpy as jnp

    from vdn.models.refine import RefineVideoDepth
    from vdn.train.trainer import RefineTrainer

    model = RefineVideoDepth(version=4, encoder=encoder, compute_dtype=dtype,
                             remat=remat, **model_kw)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 2, 56, 56), jnp.float32))
    return RefineTrainer(model, initial_lr=1e-5, stable_scale=10.0,
                         mesh=mesh), params


def trainer_state_copy(params):
    """A copy of ``params`` (train steps donate their state)."""
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.copy, params)


def attention_impls_in(lowered_text: str) -> dict:
    """Which cuDNN attention kernels a lowered step calls."""
    calls = set(re.findall(r"__cudnn\$fmha\w*", lowered_text))
    return {"cudnn_fwd": any(not c.endswith("Backward") for c in calls),
            "cudnn_bwd": any(c.endswith("Backward") for c in calls)}


def phase_train(trainer, params, batch, steps: int, expect_cudnn: bool
                ) -> dict:
    import jax
    import jax.numpy as jnp

    from vdn.train.trainer import preprocess_depth_sequences

    state = trainer.init_state(params)
    inp = preprocess_depth_sequences(jnp.asarray(batch["depth_anything_v2"]),
                                     jnp.asarray(batch["mask"]), norm=False)
    text = trainer._train_step.lower(
        state, inp, jnp.asarray(batch["depth"]),
        jnp.asarray(batch["mask"])).as_text()
    found = attention_impls_in(text)
    log(f"  attention kernels in the train step: {found} "
        f"(expected cuDNN: {expect_cudnn})")
    if found["cudnn_fwd"] != expect_cudnn or found["cudnn_bwd"] != \
            expect_cudnn:
        raise AssertionError(f"train step attention {found}, expected "
                             f"cuDNN={expect_cudnn}")
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss_dict = trainer.train_step(state, batch)
        losses.append(float(loss_dict["total_loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train losses {losses}")
    steady = float(np.median(times[1:])) if steps > 1 else times[0]
    log(f"  train losses {['%.5f' % x for x in losses]}; first step "
        f"{times[0]:.2f} s (compiles), steady {1e3 * steady:.1f} ms/step")
    return {"losses": losses, "step_ms": 1e3 * steady}


# ---------------------------------------------------------------- 4 cards

def phase_context_parallel(encoder: str, dtype, seed: int, frames: int,
                           size: int, n_dev: int) -> dict:
    """Clip forward with the frame axis over ``seq=n_dev`` against the
    one-card forward of the same clip."""
    import jax
    import jax.numpy as jnp

    from vdn.parallel.context import make_context_parallel_forward
    from vdn.parallel.mesh import SEQ_AXIS, make_mesh

    single, params = build_clip_model(encoder, dtype, seed,
                                      num_frames=frames)
    import dataclasses
    parallel = dataclasses.replace(single, seq_axis=SEQ_AXIS)
    mesh = make_mesh(data=1, seq=n_dev)
    x = jnp.asarray(synthetic_clip(frames, size, size, seed)[None],
                    jnp.float32) / 255.0
    fwd = make_context_parallel_forward(parallel, mesh)
    t0 = time.perf_counter()
    with mesh:
        got = fwd(params, x)
        got.block_until_ready()
        devices = {s.device for s in got.addressable_shards}
        log(f"  context-parallel output on {len(devices)} devices: "
            f"{sorted(str(d) for d in devices)}; first call (compile) "
            f"{time.perf_counter() - t0:.1f} s")
        t_cp = timed(fwd, params, x, reps=3)
    if len(devices) != n_dev:
        raise AssertionError(f"shards on {len(devices)} devices")
    one = jax.jit(single.apply)
    t0 = time.perf_counter()
    ref = one(params, x)
    ref.block_until_ready()
    log(f"  one-card forward first call (compile) "
        f"{time.perf_counter() - t0:.1f} s")
    t_one = timed(one, params, x, reps=3)
    log(f"  clip {frames}x{size}x{size}: {n_dev} cards {1e3 * t_cp:.1f} ms,"
        f" one card {1e3 * t_one:.1f} ms")
    err = rel_err(jax.device_get(got), jax.device_get(ref))
    check("context-parallel vs one card (rel err)", err, CP_TOL)
    return {"cp_ms": 1e3 * t_cp, "one_ms": 1e3 * t_one, "rel_err": err}


def adam_first_moments(opt_state):
    """The Adam first moments of an optimizer state.  After one step from
    a fresh state they are (1 - b1) times that step's gradients."""
    import jax
    import optax
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    return [s.mu for s in jax.tree.leaves(opt_state, is_leaf=is_adam)
            if is_adam(s)]


def phase_data_parallel(encoder: str, dtype, seed: int, b: int, t: int,
                        size: int, n_dev: int, remat: bool = True) -> dict:
    """One v4 train step over ``data=n_dev`` against the same global batch
    on one card: the step's loss, its gradients (read back from Adam's
    first moments) and where the batch and the state live."""
    import jax

    from vdn.parallel.mesh import make_mesh

    mesh = make_mesh(data=n_dev)
    batch = train_batch(b, t, size, seed)
    dp, params = build_trainer(encoder, dtype, seed, mesh=mesh, remat=remat)
    one, _ = build_trainer(encoder, dtype, seed, remat=remat)
    t0 = time.perf_counter()
    with mesh:
        state_dp, loss_dp = dp.train_step(
            dp.init_state(trainer_state_copy(params)), batch)
        loss_dp = float(loss_dp["total_loss"])
    leaf = jax.tree.leaves(state_dp.params)[0]
    log(f"  data-parallel state on {len(leaf.sharding.device_set)} devices"
        f" ({leaf.sharding}); first step (compile) "
        f"{time.perf_counter() - t0:.1f} s")
    if len(leaf.sharding.device_set) != n_dev:
        raise AssertionError("train state is not on every device")
    t0 = time.perf_counter()
    state_one, loss_one = one.train_step(
        one.init_state(trainer_state_copy(params)), batch)
    loss_one = float(loss_one["total_loss"])
    log(f"  one-card step (compile) {time.perf_counter() - t0:.1f} s")
    flat = lambda g: np.concatenate([np.asarray(a, np.float64).ravel()
                                     for a in jax.tree.leaves(g)])
    log(f"  loss: {n_dev} cards {loss_dp:.6f}, one card {loss_one:.6f}")
    check("data-parallel loss (rel diff)",
          abs(loss_dp - loss_one) / max(abs(loss_one), 1e-30), DP_LOSS_TOL)
    check("data-parallel gradients (rel err)",
          rel_err(flat(adam_first_moments(state_dp.opt_state)),
                  flat(adam_first_moments(state_one.opt_state))),
          DP_GRAD_TOL)
    return {"loss_dp": loss_dp, "loss_one": loss_one}


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import vdn  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the vdn package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    from vdn.core.compile_cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")

    start = time.perf_counter()
    log("phase 0: environment")
    log(f"  {gpu_name_and_power()}")
    log(f"  jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}"
        f" {devices}")
    check_imports()
    bf16 = jnp.bfloat16
    cases = attention_cases()
    chosen = report_dispatch(cases, devices[0].platform, bf16)
    dev0 = devices[0]

    if args.chips == 4:
        if len(devices) < 4:
            raise AssertionError(f"--chips 4 needs 4 GPUs, found "
                                 f"{len(devices)}")
        with jax.default_matmul_precision("highest"):
            log("phase dp: data-parallel v4 train step, data=4, float32")
            phase_data_parallel("vitl", jnp.float32, args.seed, 4, 4, 518, 4)
            log(f"  elapsed {time.perf_counter() - start:.0f} s")
            # 4 x 16 frames: the one-card reference of a 4 x 32-frame clip
            # did not finish inside a 420 s call (PERF.md)
            log("phase cp: context-parallel clip forward, seq=4, 64 frames, "
                "float32")
            phase_context_parallel("vitl", jnp.float32, args.seed, 64, 518,
                                   4)
    else:
        log("phase 1: attention (cuDNN and XLA vs float32 reference)")
        times = phase_attention(cases, bf16, ("cudnn", "xla"),
                                seed=args.seed)
        for name, rec in times.items():
            faster = min(rec, key=lambda i: rec[i].get(
                "fwd_bwd_ms", rec[i]["fwd_ms"]))
            log(f"  {name}: faster {faster}, dispatcher {chosen[name]}")
        log(f"  peak device memory {peak_gib(dev0):.2f} GiB")

        log(f"  elapsed {time.perf_counter() - start:.0f} s")
        log("phase 2: clip video depth (vitl, 54 x 480x640)")
        model, params = build_clip_model("vitl", bf16, args.seed)
        frames = synthetic_clip(54, 480, 640, args.seed)
        phase_clip(model, params, frames, 518)
        log(f"  peak device memory {peak_gib(dev0):.2f} GiB")

        log(f"  elapsed {time.perf_counter() - start:.0f} s")
        log("phase 3: streaming (seed frame + 8-frame chunks)")
        phase_stream(model, params, frames[:33], 518, 8)
        log(f"  peak device memory {peak_gib(dev0):.2f} GiB")
        del model, params

        log(f"  elapsed {time.perf_counter() - start:.0f} s")
        log("phase 4: RefineTrainer v4 (vitl/518, B=2, T=8)")
        trainer, tparams = build_trainer("vitl", bf16, args.seed)
        phase_train(trainer, tparams, train_batch(2, 8, 518, args.seed),
                    3, expect_cudnn=chosen["vit_self_518x518"] == "cudnn")
        log(f"  peak device memory {peak_gib(dev0):.2f} GiB")

    log(f"  elapsed {time.perf_counter() - start:.0f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
