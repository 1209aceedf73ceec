"""Stateful single-image inference with cross-frame memory.

Thin host wrapper preserving the reference's public ergonomics
(``infer_image(raw_bgr, input_size)`` / ``clear_memory()``, reference
depth_anything_v2/depth_anything_v2.py:57-92) over the functional vdn model:
memory lives in an explicit ring-buffer state carried between calls.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import numpy as np

from vdn.models.depth_anything_v2 import DepthAnythingV2
from vdn.nn.memory import init_memory_state, update_memory_state
from vdn.ops.resize import resize2d
from vdn.pipelines.transform import image2tensor_bgr


class DepthAnythingV2Pipeline:
    def __init__(self, model: DepthAnythingV2, params, capacity: int = 6):
        self.model = model
        self.params = params
        self.capacity = capacity
        self.state: Optional[Dict] = None

        def fwd_nomem(params, x):
            return model.apply(params, x, None)

        def fwd_mem(params, x, state):
            return model.apply(params, x, state)

        def encode_and_update(params, mem_feat, depth, state):
            entry = model.apply(params, mem_feat, depth,
                                method=model.encode_memory)
            return update_memory_state(state, *entry)

        self._fwd_nomem = jax.jit(fwd_nomem)
        self._fwd_mem = jax.jit(fwd_mem)
        self._encode_and_update = jax.jit(encode_and_update)

    def clear_memory(self):
        self.state = None

    def infer_image(self, raw_bgr: np.ndarray, input_size: int = 518
                    ) -> np.ndarray:
        x, (h, w) = image2tensor_bgr(raw_bgr, input_size)
        if self.state is None:
            depth, mem_feat = self._fwd_nomem(self.params, x)
            self.state = init_memory_state(
                x.shape[0], mem_feat.shape[1], mem_feat.shape[2],
                self.capacity)
        else:
            depth, mem_feat = self._fwd_mem(self.params, x, self.state)
        self.state = self._encode_and_update(self.params, mem_feat, depth,
                                             self.state)
        out = resize2d(np.asarray(depth)[..., None], (h, w),
                       "bilinear", align_corners=True)
        return np.asarray(out)[0, :, :, 0]
