"""Streaming video depth: bounded-memory arbitrary-length clips.

Re-design of the reference streaming path
(reference video_depth_anything/video_depth_stream.py:76-160): the python
list of per-frame KV-cache tensors becomes a set of fixed-capacity device
ring buffers, so every step is a single jitted call with static shapes —
no host<->device cache traffic, device memory use is constant in clip
length.

Policy replicated exactly (reference :57-59, :133-158):
- window = entries [0:2] + [-29:] of the logical list (31 entries; frame 0
  is a permanent anchor)
- after frame id >= 11, the second-oldest entry is evicted (gap=41)
Host keeps only the logical-slot indirection (a list of ints); cache tensors
never leave the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vdn.ops.resize import resize2d
from vdn.pipelines.transform import (adjust_input_size_for_ratio,
                                     preprocess_frames)

INFER_LEN = 32
OVERLAP = 10
INTERP_LEN = 8
GAP = (INFER_LEN - OVERLAP) * 2 - 1 - (OVERLAP - INTERP_LEN)  # == 41
# max logical entries ever alive (43)
CAPACITY = GAP + 2


class VideoDepthStreamPipeline:
    """Streaming pipeline with micro-batched decode.

    ``chunk_size`` frames are decoded per jitted dispatch.  k>1 chunks use
    the scan-free batched decode (``step_batched``): encoder, head, AND
    all four temporal mixers batch over the chunk, each frame attending to
    its own 31-entry cache window through a host-built column map — the
    math is per-frame-exact because cache entries are attention-block
    *inputs* (no same-block cross-frame output dependency).  k=1 and
    context-parallel models use the per-frame ``lax.scan`` path, which is
    also the parity reference for the batched one.  Cache-window indices,
    slot writes, and the eviction policy are host-precomputed per frame.
    Chunking changes nothing numerically (up to fp reassociation in the
    batched path), only dispatch granularity.
    """

    def __init__(self, model, params, input_size: int = 518,
                 chunk_size: int = 1):
        self.model = model
        self.params = params
        self.default_input_size = input_size
        self.chunk_size = int(chunk_size)
        self.input_size: Optional[int] = None
        self.frame_hw: Optional[Tuple[int, int]] = None
        self.slots: List[int] = []       # logical order -> physical slot
        self.free: List[int] = []
        self.buffers = None              # tuple(8) of [B*N_i, CAP, C_i]
        self.id = -1
        self._pending: List[np.ndarray] = []

        def gather_window(buf, onehot):
            """buf [N, CAP, C] x onehot [31, CAP] -> [N, 31, C] by one-hot
            row mixing (exact: each output row has a single 1.0 term)."""
            return jnp.einsum("sw,nwc->nsc", onehot.astype(buf.dtype), buf)

        def first(params, x, out_hw):
            def run(m, x):
                f = m.forward_features(x)
                depth, entries = m.forward_depth(f, x.shape)
                depth = resize2d(depth[..., None], out_hw, "bilinear",
                                 align_corners=True)[..., 0]
                return depth, entries
            return model.apply(params, x, method=run)

        def step_k(params, x, buffers, sels, slots, out_hw):
            """Decode k frames in ONE dispatch.  Only the frame-sequential
            middle of the head (temporal mixers + the two coarsest
            refinenets, <=1/8 resolution) runs in a per-frame scan with
            exact cache windows (sels [k, 31]) and slot writes
            (slots [k]); the encoder AND the full-resolution head tail
            (DPTHeadTemporal.decode_pre/decode_post) batch over the whole
            chunk — they have no cross-frame dependency, so the math is
            identical to per-frame decode (parity-tested)."""
            k = x.shape[1]
            ph, pw = x.shape[2] // 14, x.shape[3] // 14

            def run(m, x):
                feats = m.forward_features(x)  # 4 x (tok [(k),N,C], cls)
                # batched frame-independent stages (frames ride the batch)
                r1, r2, l3, l4 = m.head.decode_pre(feats, ph, pw)
                r2_hw = tuple(r2.shape[-3:-1])
                l34_k = jax.tree.map(
                    lambda a: a.reshape((k, 1) + a.shape[1:]), (l3, l4))

                def body(bufs, per_frame):
                    (l3_i, l4_i), sel, slot = per_frame
                    onehot = jax.nn.one_hot(sel, CAPACITY)
                    caches = tuple(gather_window(buf, onehot)
                                   for buf in bufs)
                    p3_i, entries = m.head.decode_temporal(
                        l3_i, l4_i, r2_hw, 1, caches=caches)
                    bufs = tuple(
                        jax.lax.dynamic_update_slice(
                            buf, e.astype(buf.dtype), (0, slot, 0))
                        for buf, e in zip(bufs, entries))
                    return bufs, p3_i[0]

                bufs, p3s = jax.lax.scan(
                    body, buffers, (l34_k, sels, slots))
                # batched full-resolution tail + output resize
                depth = m.head.decode_post(p3s, r1, r2, (ph * 14, pw * 14))
                depth = jax.nn.relu(depth.astype(jnp.float32))
                depths = resize2d(depth, out_hw, "bilinear",
                                  align_corners=True)[..., 0]
                return depths, bufs
            return model.apply(params, x, method=run)

        def step_batched(params, x, buffers, colsel, slots, out_hw):
            """Decode k frames in ONE dispatch with NO per-frame scan.

            No frame's attention-block input depends on another frame's
            output at the same block (cache entries are block INPUTS), so
            the whole chunk decodes as batched window attention: colsel
            [k, 32] maps each frame's 32 window positions to a column in
            [ring(CAPACITY) ‖ in-chunk entries(k)] — host-computed from
            the same eviction bookkeeping as the scan path (which remains
            the k=1 / context-parallel path and the parity reference).
            Ring writes happen once at the end, last-writer-wins per slot
            (host guarantees in-chunk reads never go through the ring).
            """
            k = x.shape[1]
            ph, pw = x.shape[2] // 14, x.shape[3] // 14

            def run(m, x):
                feats = m.forward_features(x)
                r1, r2, l3, l4 = m.head.decode_pre(feats, ph, pw)
                onehot = jax.nn.one_hot(colsel, CAPACITY + k,
                                        dtype=jnp.float32)
                windows = tuple((buf, onehot) for buf in buffers)
                p3, entries = m.head.decode_temporal(
                    l3, l4, tuple(r2.shape[-3:-1]), k, caches=windows)
                bufs = []
                for buf, e in zip(buffers, entries):
                    e = e.astype(buf.dtype)
                    for j in range(k):
                        buf = jax.lax.dynamic_update_slice(
                            buf, e[:, j:j + 1], (0, slots[j], 0))
                    bufs.append(buf)
                depth = m.head.decode_post(p3, r1, r2, (ph * 14, pw * 14))
                depth = jax.nn.relu(depth.astype(jnp.float32))
                depths = resize2d(depth, out_hw, "bilinear",
                                  align_corners=True)[..., 0]
                return depths, tuple(bufs)
            return model.apply(params, x, method=run)

        self._first = jax.jit(first, static_argnums=(2,))
        self._step_k = jax.jit(step_k, donate_argnums=(2,),
                               static_argnums=(5,))
        self._step_batched = jax.jit(step_batched, donate_argnums=(2,),
                                     static_argnums=(5,))
        self._use_batched = getattr(model, "seq_axis", None) is None

    def reset(self):
        self.slots, self.free, self.buffers = [], [], None
        self.input_size = None
        self.frame_hw = None
        self.id = -1

    def _advance(self) -> Tuple[List[int], int]:
        """Host bookkeeping for one frame: cache window + write slot, then
        the sliding-window eviction (reference :155-158)."""
        sel = self.slots[0:2] + self.slots[-(INFER_LEN - 3):]
        assert len(sel) == INFER_LEN - 1
        slot = self.free.pop()
        self.slots.append(slot)
        if self.id + INFER_LEN > GAP + 1:
            self.free.append(self.slots.pop(1))
        return sel, slot

    def infer_video_depth_one(self, frame: np.ndarray) -> np.ndarray:
        """frame: RGB HWC (uint8 or float 0-255) -> depth [H, W] fp32."""
        return self.infer_video_depth_chunk([frame])[0]

    def infer_video_depth_chunk(self, frames,
                                fetch: bool = True) -> List[np.ndarray]:
        """Process a chunk of frames with one jitted dispatch (plus one for
        the stream's very first frame).  Semantics are identical to calling
        ``infer_video_depth_one`` per frame.

        With ``fetch=False`` the returned depths are device arrays still
        being computed (jax async dispatch) — convert with np.asarray once
        the *next* chunk is dispatched to overlap transfer with compute."""
        if self.input_size is None:
            h, w = frames[0].shape[:2]
            self.frame_hw = (h, w)
            self.input_size = adjust_input_size_for_ratio(
                h, w, self.default_input_size)
        for f in frames:
            assert f.shape[:2] == self.frame_hw
        xs = preprocess_frames(np.stack(frames), self.input_size)

        out: List[np.ndarray] = []
        i = 0
        if self.buffers is None:
            self.id += 1
            depth, entries = self._first(self.params, xs[0][None, None],
                                         self.frame_hw)
            # replicate the first frame's cache across the initial window
            # (reference video_depth_stream.py:117)
            self.buffers = tuple(
                jnp.zeros((e.shape[0], CAPACITY, e.shape[2]), e.dtype)
                .at[:, :INFER_LEN].set(e) for e in entries)
            self.slots = list(range(INFER_LEN))
            self.free = list(range(INFER_LEN, CAPACITY))
            if self.id + INFER_LEN > GAP + 1:
                self.free.append(self.slots.pop(1))
            out.append(np.asarray(depth)[0, -1])
            i = 1

        if i < len(xs):
            sels, slots_w, colsel = [], [], []
            writer = {}  # physical slot -> in-chunk frame index
            for j in range(len(xs) - i):
                self.id += 1
                sel, slot = self._advance()
                sels.append(sel)
                colsel.append([CAPACITY + writer[s] if s in writer else s
                               for s in sel] + [CAPACITY + j])
                writer[slot] = j
                slots_w.append(slot)
            x = xs[i:][None]  # [1, k, h, w, 3]
            if self._use_batched and len(slots_w) > 1:
                depths, self.buffers = self._step_batched(
                    self.params, x, self.buffers,
                    jnp.asarray(colsel, jnp.int32),
                    jnp.asarray(slots_w, jnp.int32), self.frame_hw)
            else:
                depths, self.buffers = self._step_k(
                    self.params, x, self.buffers,
                    jnp.asarray(sels, jnp.int32),
                    jnp.asarray(slots_w, jnp.int32), self.frame_hw)
            if fetch:
                depths = np.asarray(depths)  # [k, H, W]
            out.extend(depths[j] for j in range(depths.shape[0]))
        return out
