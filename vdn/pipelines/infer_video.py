"""Windowed clip inference with keyframe re-anchoring and stitching.

Host orchestration of the reference protocol (reference
video_depth_anything/video_depth.py:67-156), unchanged constants:
32-frame windows, stride 22, the first 10 inputs of each window re-use the
previous window's KEYFRAMES, then per-window least-squares scale/shift
alignment against keyframe references plus an 8-frame cross-fade.

Device work (frame preprocessing and the jitted clip forward) sees a fixed
[1, 32, h, w, 3] shape; the stitching is numpy on the host.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from vdn.ops.resize import resize2d
from vdn.ops.scale_shift import interpolate_frames_np, scale_and_shift_np
from vdn.pipelines.transform import (adjust_input_size_for_ratio,
                                     preprocess_frames)

# infer settings, do not change (reference video_depth.py:29-33)
INFER_LEN = 32
OVERLAP = 10
KEYFRAMES = [0, 12, 24, 25, 26, 27, 28, 29, 30, 31]
INTERP_LEN = 8


def make_cached_window_fns(model):
    """Jitted window steps with cross-window encoder-feature reuse.

    The reference window loop re-encodes the 10 KEYFRAMES seed frames of
    every window (video_depth.py:96-113) even though they are raw frames
    already encoded by the previous window and the ViT encoder is
    frame-independent.  ``full`` encodes all 32 frames and returns the
    per-frame features; ``cached`` gathers the previous window's features
    at the KEYFRAMES indices on device and encodes only the 22 new
    frames.  Outputs are identical to re-encoding (exactly in exact
    arithmetic; to batching-order float noise otherwise)."""
    full = jax.jit(
        lambda p, x: model.apply(p, x, method=model.forward_window))

    @jax.jit
    def cached(p, x_new, prev_feats):
        kf = tuple(KEYFRAMES)
        seed = []
        for layer in prev_feats:
            gathered = []
            for a in layer:
                a = a.reshape(-1, INFER_LEN, *a.shape[1:])[:, kf]
                gathered.append(a.reshape(-1, *a.shape[2:]))
            seed.append(tuple(gathered))
        return model.apply(p, x_new, seed,
                           method=model.forward_window_cached)

    return full, cached


def infer_video_depth(model, params, frames: np.ndarray, target_fps: float,
                      input_size: int = 518,
                      forward_fn: Optional[object] = None,
                      cache_encoder: bool = True):
    """frames: [N, H, W, 3] RGB (uint8 or float 0-255).

    Returns (depths [N, H, W] fp32 at source resolution, target_fps).

    ``cache_encoder`` (default): reuse the previous window's encoder
    features for the KEYFRAMES seed frames instead of re-encoding them —
    see make_cached_window_fns.  Passing ``forward_fn`` forces the plain
    per-window path (e.g. a context-parallel shard_map forward).
    """
    n_frames = len(frames)
    frame_h, frame_w = frames[0].shape[:2]
    input_size = adjust_input_size_for_ratio(frame_h, frame_w, input_size)

    if forward_fn is not None:
        cache_encoder = False
    elif cache_encoder:
        full_fn, cached_fn = make_cached_window_fns(model)
    else:
        forward_fn = jax.jit(lambda p, x: model.apply(p, x))

    frame_list = [frames[i] for i in range(n_frames)]
    frame_step = INFER_LEN - OVERLAP
    append_len = ((frame_step - (n_frames % frame_step)) % frame_step
                  + (INFER_LEN - frame_step))
    frame_list = frame_list + [frame_list[-1].copy()] * append_len

    depth_list = []
    pre_input = None
    prev_feats = None
    for frame_id in range(0, n_frames, frame_step):
        if cache_encoder:
            if prev_feats is None:
                cur = preprocess_frames(
                    np.stack(frame_list[frame_id:frame_id + INFER_LEN]),
                    input_size)[None]
                depth, prev_feats = full_fn(params, cur)
            else:
                x_new = preprocess_frames(
                    np.stack(frame_list[frame_id + OVERLAP:
                                        frame_id + INFER_LEN]),
                    input_size)[None]
                depth, prev_feats = cached_fn(params, x_new, prev_feats)
            depth = np.asarray(depth)
        else:
            cur = preprocess_frames(
                np.stack(frame_list[frame_id:frame_id + INFER_LEN]),
                input_size)[None]
            if pre_input is not None:
                cur = cur.at[:, :OVERLAP].set(
                    pre_input[:, np.asarray(KEYFRAMES)])
            depth = np.asarray(forward_fn(params, cur))  # [1, T, h, w]
            pre_input = cur
        depth = np.asarray(resize2d(depth[0][..., None],
                                    (frame_h, frame_w), "bilinear",
                                    align_corners=True))[..., 0]
        depth_list += [depth[i] for i in range(depth.shape[0])]

    # ---- stitching (reference video_depth.py:118-154) ----
    aligned = []
    ref_align = []
    align_len = OVERLAP - INTERP_LEN
    kf_align_list = KEYFRAMES[:align_len]

    for frame_id in range(0, len(depth_list), INFER_LEN):
        if not aligned:
            aligned += depth_list[:INFER_LEN]
            for kf_id in kf_align_list:
                ref_align.append(depth_list[frame_id + kf_id])
        else:
            curr_align = [depth_list[frame_id + i]
                          for i in range(len(kf_align_list))]
            scale, shift = scale_and_shift_np(
                np.concatenate(curr_align), np.concatenate(ref_align),
                np.ones_like(np.concatenate(ref_align)))

            pre_depths = aligned[-INTERP_LEN:]
            post_depths = depth_list[frame_id + align_len:
                                     frame_id + OVERLAP]
            post_depths = [np.maximum(d * scale + shift, 0)
                           for d in post_depths]
            aligned[-INTERP_LEN:] = interpolate_frames_np(pre_depths,
                                                          post_depths)
            for i in range(OVERLAP, INFER_LEN):
                aligned.append(np.maximum(
                    depth_list[frame_id + i] * scale + shift, 0))
            ref_align = ref_align[:1]
            for kf_id in kf_align_list[1:]:
                ref_align.append(np.maximum(
                    depth_list[frame_id + kf_id] * scale + shift, 0))

    return np.stack(aligned[:n_frames], axis=0), target_fps
