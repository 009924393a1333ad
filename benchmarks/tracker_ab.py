"""Tracker A/B on one GPU: the fused kernel against the plain XLA tracker,
inside the full pipeline, plus the XLA time of FAST detection.

Measures, on the card (exits non-zero without one):
  * end-to-end frames/s of bench.py's vision-only cell (640x480 ÷4, 128
    slots, 240 frames) and of its 16-lane vmapped cell, with the tracker
    the selector picks on the GPU and with ``klt.track_xla`` forced, run
    in turns (kernel, xla, xla, kernel), each a median of 3 timed runs;
  * the device-looped time of ``fast.detect`` (with NMS) at 160x120,
    320x240 and 640x480, and its share of the vision-only frame time;
  * a profiler trace of 20 frames of the vision-only cell on each tracker
    path, reduced to device busy share, kernel launches and device-to-host
    copies per frame, and the top device operations.

Writes results/tracker_ab.json and prints a summary.

Run: python benchmarks/tracker_ab.py
"""
from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import statistics
import sys
import shutil
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _rollouts(cfg, cam):
    """Fresh jitted single and 16-lane rollouts, traced now (a patched
    selector is seen by these traces only)."""
    import jax

    from ekf_vio_tpu import engine

    def one(im, t):
        return engine.run_sequence.__wrapped__(im, t, cfg, cam)

    return jax.jit(one), jax.jit(jax.vmap(one))


def _path(name):
    """Context in which new traces take the named tracker path."""
    from ekf_vio_tpu.frontend import klt

    if name == "xla":
        return mock.patch.object(klt, "selected_backend",
                                 lambda *a, **k: "xla")
    return contextlib.nullcontext()


def _fps(fn, args, frames, repeats=3):
    import jax

    dts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        dts.append(time.perf_counter() - t0)
    return frames / statistics.median(dts)


def _device_loop_ms(fn, x, iters=100):
    """Per-call device time of fn(x) looped in one scan (no dispatch per
    call); the loop carries a dependence so nothing is hoisted."""
    import jax

    def body(c, _):
        return c + 1e-6 * fn(c)[0, 0], None

    run = jax.jit(lambda c: jax.lax.scan(body, c, None, length=iters)[0])
    jax.block_until_ready(run(x))
    t0 = time.perf_counter()
    for _ in range(3):
        r = run(x)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / (3 * iters) * 1e3


def reduce_trace(trace_dir, n_frames):
    """Device busy share, launches and D2H copies per frame, top ops,
    from the xplane file jax.profiler wrote under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    prof = ProfileData.from_file(max(paths))
    spans, ops = [], collections.Counter()
    d2h = 0
    lines = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines[f"{plane.name} {line.name}"] = sum(1 for _ in line.events)
            # kernel and copy events sit on the stream lines; the module
            # and op lines above them are summaries that overlap them
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                name = ev.name
                if "memcpy" in name.lower() and ("dtoh" in name.lower()
                                                 or "d2h" in name.lower()):
                    d2h += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                ops[name] += ev.duration_ns
    if not spans:
        return {"error": "no GPU device events",
                "planes": [p.name for p in prof.planes]}
    spans.sort()
    busy, cur_s, cur_e = 0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return {
        "window_ms": window / 1e6,
        "device_busy_share": busy / window,
        "device_events_per_frame": len(spans) / n_frames,
        "d2h_copies_per_frame": d2h / n_frames,
        "top_ops_ms": {k: v / 1e6 for k, v in ops.most_common(12)},
        "lines": lines,
    }


def main():
    import jax
    import jax.numpy as jnp

    import bench
    import ekf_vio_tpu
    from ekf_vio_tpu.frontend import fast

    ekf_vio_tpu.enable_compile_cache()
    device = bench.require_gpu()
    card = bench.nvidia_smi()
    out = {"device": device, "card": card}
    print(f"card: {card}; device: {device}", flush=True)

    frames, times = bench.make_frames()
    cfg = bench.vision_cfg()
    cam, small = bench.processing_inputs(frames, cfg)
    ts = jnp.asarray(times)
    lanes = 16
    imgs_b = jnp.broadcast_to(small, (lanes,) + small.shape)
    ts_b = jnp.broadcast_to(ts, (lanes, len(times)))
    n = len(times) - 1

    variants = {}
    for name in ("kernel", "xla"):
        with _path(name):
            single, batched = _rollouts(cfg, cam)
            t0 = time.perf_counter()
            jax.block_until_ready(single(small, ts))
            c1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            jax.block_until_ready(batched(imgs_b, ts_b))
            c2 = time.perf_counter() - t0
        variants[name] = (single, batched)
        out[f"{name}_first_call_s"] = {"single": c1, "batch16": c2}

    runs = collections.defaultdict(list)
    for name in ("kernel", "xla", "xla", "kernel"):
        single, batched = variants[name]
        runs[f"{name}_single_fps"].append(_fps(single, (small, ts), n))
        runs[f"{name}_batch16_fps"].append(
            _fps(batched, (imgs_b, ts_b), lanes * n))
    out["end_to_end"] = dict(runs)
    for k, v in runs.items():
        print(f"{k}: {v}", flush=True)

    # FAST detection, XLA-compiled, at three frame sizes
    rng = np.random.RandomState(0)
    fast_ms = {}
    for h, w in ((120, 160), (240, 320), (480, 640)):
        img = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
        fast_ms[f"{w}x{h}"] = _device_loop_ms(
            lambda x: fast.detect(x, float(cfg.fast_threshold)), img)
    out["fast_detect_ms"] = fast_ms
    frame_ms = 1e3 / statistics.median(runs["kernel_single_fps"])
    out["fast_share_of_vision_frame"] = fast_ms["160x120"] / frame_ms
    print(f"fast.detect ms: {fast_ms}; share of the 160x120 frame "
          f"({frame_ms:.3f} ms): {out['fast_share_of_vision_frame']:.3f}",
          flush=True)

    # traces of 20 frames on each path
    k = 20
    out["trace"] = {}
    for name in variants:
        sub = (small[:k + 1], ts[:k + 1])
        with _path(name):
            run = _rollouts(cfg, cam)[0]
            jax.block_until_ready(run(*sub))
        d = os.path.join(REPO, "results", f"trace_{name}")
        with jax.profiler.trace(d):
            jax.block_until_ready(run(*sub))
        out["trace"][name] = reduce_trace(d, k)
        shutil.rmtree(d)
        print(f"trace {name}: {json.dumps(out['trace'][name])}", flush=True)

    os.makedirs(os.path.join(REPO, "results"), exist_ok=True)
    with open(os.path.join(REPO, "results", "tracker_ab.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
