"""Parameter sharding rules: tensor parallelism for the ViT encoder.

The reference has no TP (SURVEY §2.9); vdn shards the transformer's wide
matmuls over the 'model' mesh axis for the vitg (1.3B) encoder — the
pjit/GSPMD style: annotate parameter shardings, let XLA insert the
collectives over NVLink.

Rules (classic Megatron split, applied by parameter path):
  attn qkv kernel   [C, 3C]   -> shard output dim   P(None, 'model')
  attn proj kernel  [C, C]    -> shard input dim    P('model', None)
  mlp fc1/w12       [C, H]    -> shard output dim   P(None, 'model')
  mlp fc2/w3        [H, C]    -> shard input dim    P('model', None)
  biases of row-sharded layers shard on their only dim; everything else
  replicates.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vdn.parallel.mesh import MODEL_AXIS

__all__ = ["vit_tp_rules", "shard_params", "assert_tp_coverage"]

_COL_PARALLEL = ("qkv", "fc1", "w12")   # kernel [in, out]: shard out
_ROW_PARALLEL = ("proj", "fc2", "w3")   # kernel [in, out]: shard in


def _spec_for_path(path, value) -> P:
    names = [getattr(p, "key", "") for p in path]
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if getattr(value, "ndim", 0) == 2 and leaf == "kernel":
        # rank-2 only: conv kernels (e.g. patch_embed "proj") replicate
        if parent in _COL_PARALLEL:
            return P(None, MODEL_AXIS)
        if parent in _ROW_PARALLEL:
            return P(MODEL_AXIS, None)
    if leaf == "bias" and parent in _COL_PARALLEL and getattr(
            value, "ndim", 0) == 1:
        return P(MODEL_AXIS)
    return P()


def vit_tp_rules(params: Any) -> Any:
    """PartitionSpec pytree for a param tree containing a ViT encoder."""
    return jax.tree_util.tree_map_with_path(_spec_for_path, params)


def assert_tp_coverage(params: Any, rules: Any = None, *,
                       min_dim: int = 1024,
                       allow_replicated: tuple = ()) -> None:
    """Fail loudly if a wide matmul silently replicates.

    The rules above match by parameter *name* (qkv/proj/fc1/...), so a
    renamed layer would fall through to P() and replicate 100s of MB per
    device without any error.  This walks the tree and raises if any
    rank-2 kernel with both dims >= ``min_dim`` (every attention/MLP
    matmul of vitl/vitg clears this; per-head and conv kernels don't)
    got a fully-replicated spec and its path is not explicitly listed in
    ``allow_replicated`` (substring match on the '/'-joined path).
    """
    if rules is None:
        rules = vit_tp_rules(params)
    flat_params = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_rules = jax.tree_util.tree_leaves(
        rules, is_leaf=lambda x: isinstance(x, P))
    assert len(flat_params) == len(flat_rules), "rules tree mismatch"
    offenders = []
    for (path, value), spec in zip(flat_params, flat_rules):
        if getattr(value, "ndim", 0) != 2:
            continue
        if min(value.shape) < min_dim:
            continue
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if any(a in name for a in allow_replicated):
            continue
        if all(axis is None for axis in spec):
            offenders.append(f"{name} {tuple(value.shape)} -> {spec}")
    if offenders:
        raise ValueError(
            "tensor-parallel rules left wide matmuls replicated "
            "(rename fell through the name-based rules?):\n  "
            + "\n  ".join(offenders))


def shard_params(params: Any, mesh: Mesh, rules: Any = None,
                 check_coverage: bool = False, **coverage_kwargs) -> Any:
    """device_put the params with NamedShardings derived from the rules.

    ``check_coverage=True`` runs :func:`assert_tp_coverage` first so a
    renamed wide matmul fails instead of silently replicating."""
    if rules is None:
        rules = vit_tp_rules(params)
    if check_coverage:
        assert_tp_coverage(params, rules, **coverage_kwargs)
    return jax.tree_util.tree_map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        params, rules)
