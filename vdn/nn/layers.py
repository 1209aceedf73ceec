"""Shared building blocks (NHWC convs, torch-compatible semantics).

These are the primitives the DINOv2 encoder and DPT heads are assembled
from.  Layouts are NHWC, HWIO kernels and tokens [B, N, C];
numerics match the torch reference so converted checkpoints reproduce
reference outputs (see tests/test_vit_parity.py).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

from vdn.nn import module as nn


Dtype = Any


def _conv_nhwc(x, kernel, stride, pad, fgc, accum_dtype):
    # pad: (ph, pw) symmetric ints, or ((lo, hi), (lo, hi)) explicit
    padding = [p if isinstance(p, tuple) else (p, p) for p in pad]
    return lax.conv_general_dilated(
        x, kernel, window_strides=stride, padding=padding,
        feature_group_count=fgc,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=accum_dtype)


import functools as _functools


@_functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
def _conv_nhwc_accum(x, kernel, stride, pad, fgc, accum_dtype):
    """Mixed-dtype conv (e.g. bf16 in, fp32 accumulate+out).  XLA's
    built-in conv gradient rejects cotangent/operand dtype mixes, so the
    backward casts the cotangent to the input dtype and differentiates
    the same-dtype conv — exactly the gradient a bf16 conv would produce
    (matching the reference's autocast backward semantics)."""
    return _conv_nhwc(x, kernel, stride, pad, fgc, accum_dtype)


def _conv_accum_fwd(x, kernel, stride, pad, fgc, accum_dtype):
    return _conv_nhwc_accum(x, kernel, stride, pad, fgc, accum_dtype), \
        (x, kernel)


def _conv_accum_bwd(stride, pad, fgc, accum_dtype, res, g):
    x, kernel = res
    _, vjp = jax.vjp(
        lambda x, k: _conv_nhwc(x, k, stride, pad, fgc, None), x, kernel)
    return vjp(g.astype(x.dtype))


_conv_nhwc_accum.defvjp(_conv_accum_fwd, _conv_accum_bwd)


class Conv2d(nn.Module):
    """NHWC conv with torch-style symmetric integer padding.

    ``accum_dtype`` sets the accumulator/output dtype independently of the
    input dtype (e.g. bf16 inputs with fp32 accumulation + fp32 output for
    the DPT output island — the counterpart of the reference's
    out-of-autocast fp32 conv, reference dpt_temporal.py:108-110)."""
    features: int
    kernel_size: Tuple[int, int]
    stride: Tuple[int, int] = (1, 1)
    padding: Union[int, Tuple[int, int]] = 0
    use_bias: bool = True
    feature_group_count: int = 1
    param_dtype: Dtype = jnp.float32
    accum_dtype: Any = None

    @nn.compact
    def __call__(self, x, *, params_only: bool = False):
        kh, kw = self.kernel_size
        in_ch = x.shape[-1]
        kernel = self.param(
            "kernel",
            jax.nn.initializers.variance_scaling(1 / 3, "fan_in", "uniform"),
            (kh, kw, in_ch // self.feature_group_count, self.features),
            self.param_dtype)
        if params_only:  # raw params for the packed island head
            bias = self.param("bias", jax.nn.initializers.zeros,
                              (self.features,), self.param_dtype) \
                if self.use_bias else None
            return kernel, bias
        pad = self.padding if isinstance(self.padding, tuple) else (
            self.padding, self.padding)
        conv = _conv_nhwc_accum if (
            self.accum_dtype is not None
            and self.accum_dtype != jnp.result_type(x)) else _conv_nhwc
        y = conv(x, kernel.astype(x.dtype), tuple(self.stride), pad,
                 self.feature_group_count, self.accum_dtype)
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros,
                              (self.features,), self.param_dtype)
            y = y + bias.astype(y.dtype)
        return y


class ConvTranspose2d(nn.Module):
    """NHWC transposed conv matching torch ConvTranspose2d (padding=0).

    The kernel is stored spatially *flipped* in HWIO layout so that
    ``lax.conv_transpose`` reproduces torch's placement convention; the
    checkpoint converter performs the flip once at load time.
    """
    features: int
    kernel_size: Tuple[int, int]
    stride: Tuple[int, int]
    use_bias: bool = True
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        kh, kw = self.kernel_size
        kernel = self.param(
            "kernel",
            jax.nn.initializers.variance_scaling(1 / 3, "fan_in", "uniform"),
            (kh, kw, x.shape[-1], self.features), self.param_dtype)
        y = lax.conv_transpose(
            x, kernel.astype(x.dtype), strides=self.stride, padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros,
                              (self.features,), self.param_dtype)
            y = y + bias.astype(y.dtype)
        return y


class LayerNorm(nn.Module):
    epsilon: float = 1e-6
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        dim = x.shape[-1]
        scale = self.param("scale", jax.nn.initializers.ones, (dim,),
                           self.param_dtype)
        bias = self.param("bias", jax.nn.initializers.zeros, (dim,),
                          self.param_dtype)
        xf = x.astype(jnp.float32)
        mean = xf.mean(-1, keepdims=True)
        var = jnp.mean(jnp.square(xf - mean), -1, keepdims=True)
        y = (xf - mean) * lax.rsqrt(var + self.epsilon)
        y = y * scale.astype(jnp.float32) + bias.astype(jnp.float32)
        return y.astype(x.dtype)


class GroupNorm(nn.Module):
    """Channel-last group norm (torch GroupNorm semantics)."""
    num_groups: int
    epsilon: float = 1e-6
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        ch = x.shape[-1]
        g = self.num_groups
        scale = self.param("scale", jax.nn.initializers.ones, (ch,),
                           self.param_dtype)
        bias = self.param("bias", jax.nn.initializers.zeros, (ch,),
                          self.param_dtype)
        orig_shape = x.shape
        xf = x.astype(jnp.float32).reshape(orig_shape[0], -1, g, ch // g)
        mean = xf.mean(axis=(1, 3), keepdims=True)
        var = jnp.mean(jnp.square(xf - mean), axis=(1, 3), keepdims=True)
        y = (xf - mean) * lax.rsqrt(var + self.epsilon)
        y = y.reshape(orig_shape)
        y = y * scale.astype(jnp.float32) + bias.astype(jnp.float32)
        return y.astype(x.dtype)


class Linear(nn.Module):
    features: int
    use_bias: bool = True
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = jax.nn.initializers.lecun_normal()

    @nn.compact
    def __call__(self, x, *, params_only: bool = False):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        bias = self.param("bias", jax.nn.initializers.zeros,
                          (self.features,), self.param_dtype) \
            if self.use_bias else None
        if params_only:  # raw params for head-major projections
            return kernel, bias
        y = jnp.matmul(x, kernel.astype(x.dtype))
        if bias is not None:
            y = y + bias.astype(y.dtype)
        return y


class Mlp(nn.Module):
    """fc1 -> GELU(exact) -> fc2 (reference dinov2_layers/mlp.py)."""
    hidden_features: int
    out_features: int
    use_bias: bool = True
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = Linear(self.hidden_features, self.use_bias, self.param_dtype,
                   name="fc1")(x)
        x = jax.nn.gelu(x, approximate=False)
        return Linear(self.out_features, self.use_bias, self.param_dtype,
                      name="fc2")(x)


class SwiGLUFFN(nn.Module):
    """SwiGLU FFN used by vitg (reference dinov2_layers/swiglu_ffn.py):
    hidden = (2/3 * 4d) rounded up to a multiple of 8."""
    hidden_features: int
    out_features: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x12 = Linear(2 * self.hidden_features, True, self.param_dtype,
                     name="w12")(x)
        x1, x2 = jnp.split(x12, 2, axis=-1)
        return Linear(self.out_features, True, self.param_dtype,
                      name="w3")(jax.nn.silu(x1) * x2)
