"""vdn — Video-Depth-Normal, a JAX depth estimation framework.

A from-scratch JAX/XLA re-design of the capabilities of the
Video-Depth-Normal-v2 reference (Depth-Anything-V2 + Video-Depth-Anything +
SAM2-derived memory attention + depth-refinement research models), running
on NVIDIA GPUs:

- NHWC layouts, bf16 compute with fp32 parameter/softmax/output islands
- static shapes everywhere (ring buffers instead of python list caches)
- `jax.sharding.Mesh` + shard_map parallelism (data / sequence axes)
- cuDNN fused attention for the long-sequence attention (vdn.ops.attention)

Subpackages
-----------
core       dtype policy, checkpoint io (torch .pth reader, orbax), conversion
ops        resize/attention/rope/scale-shift/normals
nn         modules (vdn.nn.module): DINOv2 ViT, DPT heads, motion modules,
           memory blocks
models     assembled models: DepthAnythingV2, VideoDepthAnything (clip/stream)
pipelines  host-side orchestration: preprocessing, windowed & streaming infer
parallel   mesh construction, sharding rules, context-parallel attention
train      losses, optimizers, trainers
eval       metric suites & benchmark harness
data       dataset registry and loaders
"""

__version__ = "0.1.0"
