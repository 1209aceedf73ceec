"""Device mesh construction and axis conventions.

The reference's entire distributed story is NCCL DDP
(reference metric_depth/util/dist_helper.py:8-41, metric_depth/train.py:93-96).
Here it is a named mesh + sharding annotations; XLA inserts the collectives
(gradient psum over 'data', temporal-attention collectives over 'seq') and
hands them to NCCL over NVLink.  NVLink joins the cards all to all, so the
mesh is a plain reshape of the device list and follows the algorithm alone.

Axes:
  data  — batch (DP; replaces DDP/all-reduce)
  seq   — frame axis of a clip (context parallel; temporal attention spans it)
  model — reserved for tensor parallelism of vitg
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, seq: int = 1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // (seq * model)
    assert data * seq * model == n, (
        f"mesh {data}x{seq}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, seq, model)
    return Mesh(arr, (DATA_AXIS, SEQ_AXIS, MODEL_AXIS))


def clip_sharding(mesh: Mesh) -> NamedSharding:
    """[B, T, H, W, C] clips: batch over data, frames over seq."""
    return NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
