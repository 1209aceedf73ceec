"""Aggregate a jax.profiler trace's device op time by JAX source scope.

Usage: python tools/trace_by_source.py profiles/train [category-substring]
       [scope-prefix-substring] [depth]

Groups XLA op self-time by the `tf_op`/source metadata path (the JAX
name-stack, e.g. transpose(jvp(RefineVideoDepth))/temporal_head/...),
optionally filtered to one HLO category (e.g. "convolution").  This is
the drill-down companion to tools/parse_trace.py: that one says "conv
fusions are 51%", this one says *which module's* convs.
"""

from __future__ import annotations

import sys
from collections import defaultdict

from parse_trace import find_xplane  # noqa: E402


def short_scope(op_name: str, depth: int = 4) -> str:
    parts = [p for p in op_name.split("/") if p]
    # drop the jit wrapper, keep transpose()/jvp() markers on the segments
    if parts and parts[0].startswith("jit("):
        parts = parts[1:]
    return "/".join(parts[:depth])


def main():
    trace_dir = sys.argv[1] if len(sys.argv) > 1 else "profiles/train"
    want_cat = sys.argv[2] if len(sys.argv) > 2 else None
    want_scope = sys.argv[3] if len(sys.argv) > 3 else None
    depth = int(sys.argv[4]) if len(sys.argv) > 4 else 4
    path = find_xplane(trace_dir)
    try:
        from tensorflow.core.profiler.protobuf import xplane_pb2  # type: ignore
    except ModuleNotFoundError:
        from tensorflow.tsl.profiler.protobuf import xplane_pb2  # type: ignore
    xspace = xplane_pb2.XSpace()
    with open(path, "rb") as f:
        xspace.ParseFromString(f.read())

    for plane in xspace.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        ev_meta = plane.event_metadata
        stats_meta = plane.stat_metadata
        per_scope = defaultdict(float)
        counts = defaultdict(int)
        total = 0.0
        for line in plane.lines:
            if "XLA Op" not in line.name and "XLA Ops" not in line.name:
                continue
            for ev in line.events:
                meta = ev_meta[ev.metadata_id]
                dur = ev.duration_ps / 1e9  # ms
                cat, src = "", ""
                for st in list(ev.stats) + list(meta.stats):
                    sname = stats_meta[st.metadata_id].name
                    if sname == "hlo_category":
                        cat = st.str_value
                    elif sname in ("tf_op", "source", "op_name"):
                        src = st.str_value or src
                base = meta.name.split(".")[0].split("(")[0].lstrip("%")
                if "-start" in base or "-done" in base:
                    continue
                if want_cat and want_cat != "all" \
                        and want_cat not in (cat or base):
                    continue
                if want_scope and want_scope not in src:
                    continue
                if want_scope:
                    tail = "/".join(src.split("/")[-depth:])
                    key = f"[{cat or base}] .../{tail}"
                else:
                    key = short_scope(src, depth) if src \
                        else f"<no-src> {base}"
                per_scope[key] += dur
                counts[key] += 1
                total += dur
        if not per_scope:
            continue
        label = want_cat or "all"
        print(f"== {plane.name}: {label} time {total:.2f} ms by scope ==")
        for k, v in sorted(per_scope.items(), key=lambda kv: -kv[1])[:40]:
            print(f"{v:10.2f} ms  {100*v/total:5.1f}%  x{counts[k]:<4d} {k[:120]}")


if __name__ == "__main__":
    main()
