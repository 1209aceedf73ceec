"""Mixed-precision policy.

The reference uses CUDA autocast fp16 with explicit fp32 "islands" (the final
output convs of the temporal DPT head run out of autocast, and attention
softmax is optionally upcast — see reference dpt_temporal.py:108-123 and
motion_module/attention.py:198-204).  Here the policy is bf16 compute / fp32
parameters, with softmax, LayerNorm statistics and the final output convs
pinned to fp32.  A `Policy` is threaded through every module; tests run
fp32/fp32 so parity with the fp32 torch reference is exact.

Precision of the fp32 islands on the GPU: softmax and LayerNorm statistics
are elementwise/reduction work in fp32 (no tensor cores involved).  fp32
dots and convs run at JAX's default precision, which is TF32 on the H100
(about 3 decimal digits): the output island's 3x3 conv takes bf16 operands
in serving, so TF32 never applies there, and its fp32 1x1 collapse is
pinned to HIGHEST (vdn/ops/packed_conv.py).  Runs with fp32 compute (the
fp32 references of chip_smoke.py, the CPU tests) set
``jax.default_matmul_precision("highest")``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: Any = jnp.float32
    compute_dtype: Any = jnp.float32
    # dtype used for softmax / normalization statistics
    reduce_dtype: Any = jnp.float32
    # dtype of the final output convs (the reference's fp32 island)
    output_dtype: Any = jnp.float32

    def cast_to_compute(self, *xs):
        out = tuple(x.astype(self.compute_dtype) if x is not None else None for x in xs)
        return out[0] if len(out) == 1 else out


FP32 = Policy()
BF16 = Policy(compute_dtype=jnp.bfloat16)


def get_policy(name: str) -> Policy:
    return {"fp32": FP32, "float32": FP32, "bf16": BF16, "bfloat16": BF16}[name]
