"""Batch-throughput curve + profiler trace for the data-parallel engine.

Measures the B in {1, 4, 16, 64} aggregate-fps curve at the bench
operating point (bench.make_frames, 120 frames) and (optionally,
--trace) records a jax.profiler trace of the B=16 case for op-level
attribution (benchmarks/parse_trace.py reads it).

Writes results/batch_scaling.json.  Run on a GPU:
    python benchmarks/batch_scaling.py [--trace]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import ekf_vio_tpu  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ekf_vio_tpu import engine  # noqa: E402
from ekf_vio_tpu.config import VIOConfig  # noqa: E402
from ekf_vio_tpu.frontend import camera as cam_mod  # noqa: E402
from ekf_vio_tpu.parallel.batched_engine import (  # noqa: E402
    MICROBATCH, run_sequences_batched)

W_IN, H_IN, N_FRAMES = bench.W_IN, bench.H_IN, 120


def main():
    ekf_vio_tpu.enable_compile_cache()
    device = bench.require_gpu()
    do_trace = "--trace" in sys.argv
    cfg = VIOConfig(max_features=128, min_new_feature_dist=8.0,
                    fast_threshold=30)
    s = cfg.inverse_image_scale
    w, h = W_IN // s, H_IN // s
    cam = engine.make_hashable_camera(
        [[458.0 / s, 0, w / 2], [0, 458.0 / s, h / 2], [0, 0, 1]], w, h)

    frames, times = bench.make_frames(n_frames=N_FRAMES)
    small = jax.jit(lambda x: cam_mod.downscale_image(x, s))(
        jnp.asarray(frames))
    jax.block_until_ready(small)

    report = {"device": device, "card": bench.nvidia_smi(), "frames": N_FRAMES,
              "config": "640x480/4, 128 slots",
              "microbatch": MICROBATCH}
    fps1 = None
    for b in (1, 4, 16, 64):
        imgs_b = jnp.broadcast_to(small, (b,) + small.shape)
        ts_b = jnp.broadcast_to(jnp.asarray(times), (b, N_FRAMES))
        try:
            _, outs = run_sequences_batched(imgs_b, ts_b, cfg, cam)
        except Exception as e:  # record instead of dying mid-curve
            report[f"b{b}_error"] = str(e)[:200]
            print(f"B={b}: FAILED {e}", flush=True)
            continue
        jax.block_until_ready(outs)
        t0 = time.time()
        _, outs = run_sequences_batched(imgs_b, ts_b, cfg, cam)
        jax.block_until_ready(outs)
        dt = time.time() - t0
        fps = b * (N_FRAMES - 1) / dt
        if fps1 is None:  # first SUCCESSFUL B anchors the speedup column
            fps1 = fps
        report[f"b{b}_aggregate_fps"] = round(fps, 1)
        report[f"b{b}_speedup"] = round(fps / fps1, 2)
        print(f"B={b}: {fps:.1f} fps aggregate ({fps / fps1:.2f}x)", flush=True)

        if do_trace and b == 16:
            trace_dir = bench.out_path("trace_b16")
            with jax.profiler.trace(trace_dir):
                _, outs = run_sequences_batched(imgs_b, ts_b, cfg, cam)
                jax.block_until_ready(outs)
            report["trace_dir"] = trace_dir
            print("trace written to", trace_dir)

    out = bench.out_path("batch_scaling.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
