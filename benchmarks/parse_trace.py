"""Aggregate device-op durations from a jax.profiler trace directory.

Reads the perfetto trace (trace.json.gz) written by jax.profiler.trace
and prints the top-N ops by total GPU time, grouped by op name (e.g. on
the trace benchmarks/batch_scaling.py --trace writes).

Usage: python benchmarks/parse_trace.py results/trace_b16 [top_n]
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import sys


def main():
    trace_dir = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    paths = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    if not paths:
        raise SystemExit(f"no trace.json.gz under {trace_dir}")
    path = max(paths)  # latest run
    with gzip.open(path, "rt") as f:
        trace = json.load(f)

    events = trace.get("traceEvents", [])
    # device lanes: the profiler names each GPU's process "/device:GPU:<i>"
    name_by_pid = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name_by_pid[e["pid"]] = e["args"].get("name", "")
    tot = collections.Counter()
    cnt = collections.Counter()
    dev_total = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        pname = name_by_pid.get(e.get("pid"), "")
        if not pname.startswith("/device:GPU"):
            continue
        dur = e.get("dur", 0) / 1e3  # us -> ms
        key = e.get("name", "?")
        tot[key] += dur
        cnt[key] += 1
        dev_total += dur
    print(f"trace: {path}")
    print(f"total device op time: {dev_total:.1f} ms")
    print(f"{'op':60s} {'total_ms':>10s} {'calls':>8s} {'pct':>6s}")
    for name, ms in tot.most_common(top_n):
        print(f"{name[:60]:60s} {ms:10.2f} {cnt[name]:8d} "
              f"{100 * ms / max(dev_total, 1e-9):5.1f}%")


if __name__ == "__main__":
    main()
