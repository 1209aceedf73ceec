"""Summarize a jax.profiler trace: top self-time ops on the GPU device
plane(s) (``/device:GPU:N``).

Usage: python tools/parse_trace.py profiles/clip
Reads the newest .xplane.pb under the trace dir and prints a per-op-category
and per-op table of device self time.
"""

from __future__ import annotations

import glob
import os
import sys
from collections import defaultdict


def find_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def main():
    trace_dir = sys.argv[1] if len(sys.argv) > 1 else "profiles/clip"
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
        # XLA op events live on XLA Ops lines; aggregate self-time by HLO.
        # Async ops (copy-start/async-start) span until their *-done is
        # reached, overlapping real compute — bucket them separately.
        per_op = defaultdict(float)
        per_cat = defaultdict(float)
        counts = defaultdict(int)
        total = 0.0
        async_total = 0.0
        modules = defaultdict(float)
        mod_counts = defaultdict(int)
        for line in plane.lines:
            if "XLA Modules" in line.name:
                for ev in line.events:
                    name = ev_meta[ev.metadata_id].name.split("(")[0]
                    modules[name] += ev.duration_ps / 1e9
                    mod_counts[name] += 1
            if "XLA Op" not in line.name and "XLA Ops" not in line.name:
                continue
            for ev in line.events:
                meta = ev_meta[ev.metadata_id]
                dur = ev.duration_ps / 1e9  # ms
                name = meta.name
                cat = ""
                for st in list(ev.stats) + list(meta.stats):
                    sname = stats_meta[st.metadata_id].name
                    if sname in ("hlo_category", "equation", "tf_op"):
                        if sname == "hlo_category":
                            cat = st.str_value or stats_meta[
                                st.metadata_id].name
                base = name.split(".")[0].split("(")[0].lstrip("%")
                # *-start ops (copy/async/slice/all-reduce...) span until
                # their *-done and overlap real compute: bucket separately
                if ("-start" in base or "-done" in base):
                    async_total += dur
                    continue
                key = name.split(" = ")[0].lstrip("%")
                per_op[key] += dur
                counts[key] += 1
                per_cat[cat or base] += dur
                total += dur
        if not per_op:
            continue
        print(f"== plane: {plane.name}  compute XLA-op time {total:.2f} ms "
              f"(+ {async_total:.2f} ms async-copy span, overlapped) ==")
        if modules:
            print("-- XLA Modules wall (per-execution mean) --")
            for k, v in sorted(modules.items(), key=lambda kv: -kv[1])[:8]:
                print(f"{v:10.2f} ms  x{mod_counts[k]:<4d} "
                      f"(mean {v / mod_counts[k]:8.2f} ms)  {k[:70]}")
        print("NOTE: 'while' op time includes its body; body ops are also "
              "counted separately (do not sum categories with 'while').")
        print("-- by category --")
        for k, v in sorted(per_cat.items(), key=lambda kv: -kv[1])[:15]:
            print(f"{v:10.2f} ms  {100*v/total:5.1f}%  {k}")
        print("-- top ops (aggregated over executions) --")
        for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:40]:
            print(f"{v:10.2f} ms  {100*v/total:5.1f}%  x{counts[k]:<4d} "
                  f"{k[:100]}")


if __name__ == "__main__":
    main()
