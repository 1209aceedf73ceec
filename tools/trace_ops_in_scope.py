"""List individual XLA op events whose source scope matches a filter.

Usage: python tools/trace_ops_in_scope.py profiles/train blocks_11 [cat]

Companion drill-down to trace_by_source.py: prints each matching event's
HLO name, category, duration and the full source scope, so a "x6
convolution fusion" line can be resolved to the actual dots.
"""

from __future__ import annotations

import sys
from collections import defaultdict

from parse_trace import find_xplane  # noqa: E402


def main():
    trace_dir = sys.argv[1] if len(sys.argv) > 1 else "profiles/train"
    want_scope = sys.argv[2] if len(sys.argv) > 2 else ""
    want_cat = sys.argv[3] if len(sys.argv) > 3 else None
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
        rows = defaultdict(lambda: [0.0, 0, ""])
        for line in plane.lines:
            if "XLA Op" not in line.name and "XLA Ops" not in line.name:
                continue
            for ev in line.events:
                meta = ev_meta[ev.metadata_id]
                dur = ev.duration_ps / 1e9
                cat, src, expr = "", "", ""
                for st in list(ev.stats) + list(meta.stats):
                    sname = stats_meta[st.metadata_id].name
                    if sname == "hlo_category":
                        cat = st.str_value
                    elif sname in ("tf_op", "source", "op_name"):
                        src = st.str_value or src
                    elif sname in ("equation", "expression", "long_name",
                                   "hlo_expression"):
                        expr = st.str_value or expr
                base = meta.name.split("(")[0].lstrip("%")
                if "-start" in base or "-done" in base:
                    continue
                if want_scope and want_scope not in src:
                    continue
                if want_cat and want_cat not in (cat or base):
                    continue
                r = rows[meta.name]
                r[0] += dur
                r[1] += 1
                r[2] = f"[{cat}] {src[-110:]} || {expr[:220]}"
        for name, (dur, n, info) in sorted(rows.items(),
                                           key=lambda kv: -kv[1][0])[:30]:
            print(f"{dur:8.2f} ms x{n:<3d} {name}\n    {info}")


if __name__ == "__main__":
    main()
