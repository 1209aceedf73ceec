"""FPS/TPF benchmark harnesses (reference sam2/benchmark.py:20-92 and the
TPF printout of scripts/evaluate_v4.py:229-236).

Timing runs K iterations *inside one jitted lax.while_loop* with a traced
trip count and reports the two-point slope (bench.py's method).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import jax
import jax.numpy as jnp

__all__ = ["benchmark_fn", "benchmark_video_model"]


def benchmark_fn(fn: Callable, args, chain: Callable = None,
                 ks=(1, 5), reps: int = 3) -> Dict[str, float]:
    """Per-call seconds of ``fn(*args)`` via the in-executable slope.

    ``chain(args, out) -> args`` must derive the next iteration's inputs
    from the previous output (inside the loop, so the runtime cannot
    dedup or reorder); default folds a tanh of the first output leaf's
    mean into the first argument.
    """
    if chain is None:
        def chain(args, out):
            leaf = jax.tree.leaves(out)[0]
            bump = jnp.tanh(jnp.mean(leaf).astype(jnp.float32)) * 1e-3
            # fold the bump into the first *array leaf* of args (args[0]
            # may be a params pytree, e.g. benchmark_fn(model.apply,
            # (params, x)))
            flat, treedef = jax.tree.flatten(tuple(args))
            flat[0] = flat[0] * (1.0 + bump).astype(
                jnp.result_type(flat[0]))
            return jax.tree.unflatten(treedef, flat)

    @jax.jit
    def run(args, k):
        def body(c):
            i, a, acc = c
            out = fn(*a)
            leaves = jax.tree.leaves(out)
            # consume every leaf or XLA dead-code-eliminates the rest
            acc = acc + sum(jnp.mean(x).astype(jnp.float32)
                            for x in leaves) * 1e-6
            return i + 1, chain(a, out), acc

        _, _, acc = jax.lax.while_loop(
            lambda c: c[0] < k, body,
            (jnp.int32(0), tuple(args), jnp.float32(0.0)))
        return acc

    float(run(tuple(args), jnp.int32(1)))  # compile + warm

    def best(k):
        v = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(run(tuple(args), jnp.int32(k)))
            v = min(v, time.perf_counter() - t0)
        return v

    per = (best(ks[1]) - best(ks[0])) / (ks[1] - ks[0])
    return {"sec_per_iter": per, "iters": ks[1] - ks[0]}


def benchmark_video_model(model, params, frames: int = 32, size: int = 518,
                          ks=(1, 5)) -> Dict[str, float]:
    """Frames/sec of the clip forward on the current default device."""
    x = jax.random.normal(jax.random.PRNGKey(0),
                          (1, frames, size, size, 3), jnp.float32)

    def chain(args, out):
        p, x = args
        bump = jnp.tanh(jnp.mean(out)) * 1e-3
        return (p, x * (1.0 + bump))

    stats = benchmark_fn(model.apply, (params, x), chain=chain, ks=ks)
    fps = frames / stats["sec_per_iter"]
    return {"frames_per_sec": fps,
            "tpf_msec": stats["sec_per_iter"] / frames * 1000}
