"""Headline benchmark: frames/s of the full VIO pipeline on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}
with the device it ran on (platform, device_kind, device count, and the
card's name and power limit from nvidia-smi).  Without a GPU it exits
non-zero and prints no result.

Cells (each a frames/s over the steady-state rollout, compile excluded,
median of the timed repeats):
  * vision-only at the reference's default operating point — 640x480
    input processed at ÷4 with the 100-feature budget (Params.h:28,46)
    on 128 feature slots (the headline);
  * mono-inertial on the rendered sequence (sim/rendered.py);
  * 16 vmapped lanes of the headline cell (aggregate frames/s);
  * fast_with_insight: 400 features, 320x240, 512 slots.

Baseline: the reference algorithm on a host CPU via OpenCV
(cv::calcOpticalFlowPyrLK + cv::FAST, the calls the reference makes,
KLTTracker.cpp:61-64 / EKFVIO.cpp:242) + a NumPy dense EKF
(baselines/cpu_reference.py).  The measured value is cached in
baseline_cpu.json (delete it to re-measure; that needs OpenCV); the
result names the denominator and whether this run measured it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BASELINE_CACHE = os.path.join(REPO, "baseline_cpu.json")

W_IN, H_IN = 640, 480
N_FRAMES = 240


def make_frames(seed=0, n_frames=N_FRAMES):
    """Synthetic 640x480 sequence: corner-rich blob texture, lateral
    camera motion.  Thresholded blobs give FAST (both ours and the CPU
    reference's cv::FAST) plenty of corners at the ÷4 processing scale —
    a smooth-noise plane starves the detector and the run measures
    tracking loss instead of throughput."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    shift = 2.0  # px/frame at full res
    shape = (H_IN + 64, W_IN + 64 + int(shift * n_frames) + 8)
    smooth = ndi.gaussian_filter(rng.uniform(0, 255, shape), 2.0)
    blobs = (ndi.gaussian_filter(rng.uniform(0, 1, shape), 6.0) > 0.5) * 150.0
    big = 0.4 * smooth + blobs + 30.0
    big = (big - big.min()) / (np.ptp(big) + 1e-9) * 255.0
    big = big.astype(np.float32)
    frames = np.stack(
        [big[32 : 32 + H_IN,
             32 + int(round(shift * i)) : 32 + int(round(shift * i)) + W_IN]
         for i in range(n_frames)]
    )
    times = np.arange(n_frames, dtype=np.float32) / 20.0  # 20 fps camera
    return frames, times


def vision_cfg():
    """Headline configuration.  min_new_feature_dist: the reference
    default (30 px, Params.h:43) caps the feature count at ~20 on a
    160x120 processed frame (the exclusion disks tile the image); 8 px
    exercises the 100-feature budget.  The CPU baseline runs the same."""
    from ekf_vio_tpu.config import VIOConfig

    return VIOConfig(max_features=128, min_new_feature_dist=8.0,
                     fast_threshold=30)


def fwi_cfg():
    """The reference's high-feature operating point: 400 features, input
    ÷2 => 320x240 processed, 512 slots (params/fast_with_insight.yaml:2,23
    via configs/fast_with_insight.yaml).  min_new_feature_dist is
    tightened to 8 px for the same reason as the headline: 30 px disks
    tile a 320x240 frame at ~80 features and leave the budget idle."""
    from ekf_vio_tpu.config import VIOConfig

    cfg = VIOConfig.from_yaml(os.path.join(REPO, "configs",
                                           "fast_with_insight.yaml"))
    return cfg.replace(min_new_feature_dist=8.0, fast_threshold=30)


def imu_cfg():
    from ekf_vio_tpu.config import VIOConfig

    return VIOConfig(max_features=128, min_new_feature_dist=10.0,
                     fast_threshold=25, triangulate_new_features=True,
                     klt_measurement_variance_px=0.001, q_feature=1e-7)


def processing_inputs(frames, cfg):
    """(camera, downscaled device frames) at the config's ÷ scale."""
    import jax
    import jax.numpy as jnp

    from ekf_vio_tpu import engine
    from ekf_vio_tpu.frontend import camera as cam_mod

    s = cfg.inverse_image_scale
    w, h = W_IN // s, H_IN // s
    cam = engine.make_hashable_camera(
        [[458.0 / s, 0, w / 2], [0, 458.0 / s, h / 2], [0, 0, 1]], w, h)
    small = jax.jit(lambda x: cam_mod.downscale_image(x, s))(
        jnp.asarray(frames))
    return cam, small


def timed(fn, repeats=3):
    """Run ``fn`` once to compile, then ``repeats`` times; returns (last
    result, median seconds of the timed runs)."""
    import jax

    jax.block_until_ready(fn())
    dts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        dts.append(time.perf_counter() - t0)
    return out, statistics.median(dts)


def out_path(name: str) -> str:
    """Where a measurement script writes its record: results/ (listed in
    .gitignore; records are made at run time, never committed)."""
    d = os.path.join(REPO, "results")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def require_gpu():
    """Device record of the default backend; exits non-zero without a GPU
    (no number from another device may stand in for a GPU number)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU found (default device: {dev.platform}); "
                 "this benchmark measures the GPU only")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def bench_vision(frames, times):
    import jax.numpy as jnp

    from ekf_vio_tpu import engine

    cfg = vision_cfg()
    cam, small = processing_inputs(frames, cfg)
    ts = jnp.asarray(times)
    (_, outs), dt = timed(lambda: engine.run_sequence(small, ts, cfg, cam))
    tracked = np.asarray(outs.num_tracked)
    assert np.isfinite(np.asarray(outs.base_mu)).all(), "pipeline NaN"
    assert tracked[5:].min() > 10, f"pipeline lost tracking: {tracked}"
    return (len(times) - 1) / dt


def bench_fwi(frames, times):
    import jax.numpy as jnp

    from ekf_vio_tpu import engine

    cfg = fwi_cfg()
    assert cfg.num_features == 400 and cfg.inverse_image_scale == 2
    cam, small = processing_inputs(frames, cfg)
    ts = jnp.asarray(times)
    (estate, outs), dt = timed(
        lambda: engine.run_sequence(small, ts, cfg, cam))
    tracked = np.asarray(outs.num_tracked)
    assert np.isfinite(np.asarray(outs.base_mu)).all(), "fwi pipeline NaN"
    # the budget must actually be exercised (not a 30-feature run wearing
    # a 400-feature profile)
    assert tracked[10:].mean() > 250, f"fwi tracked only {tracked[10:].mean():.0f}"
    # checkSigma invariants at 512 slots (TightlyCoupledEKF.cpp:699-714)
    sig = np.asarray(estate.filt.Sigma)
    assert np.isfinite(sig).all(), "fwi Sigma non-finite"
    assert np.diag(sig).min() >= -1e-5, "fwi negative variance"
    assert np.abs(sig - sig.T).max() < 1e-3, "fwi Sigma asymmetric"
    return (len(times) - 1) / dt, float(tracked[10:].mean())


def bench_batched(frames, times, batch=16):
    """Aggregate frames/s with `batch` sequences vmapped on one card.
    Each lane runs the same sequence; vmap makes per-lane work
    independent, so this measures the data-parallel throughput."""
    import jax.numpy as jnp

    from ekf_vio_tpu.parallel.batched_engine import run_sequences_batched

    cfg = vision_cfg()
    cam, small = processing_inputs(frames, cfg)
    imgs_b = jnp.broadcast_to(small, (batch,) + small.shape)
    ts_b = jnp.broadcast_to(jnp.asarray(times), (batch, len(times)))
    (_, outs), dt = timed(
        lambda: run_sequences_batched(imgs_b, ts_b, cfg, cam), repeats=2)
    assert np.isfinite(np.asarray(outs.base_mu)).all(), "batched NaN"
    return batch * (len(times) - 1) / dt


def imu_inputs(num_frames):
    import jax.numpy as jnp

    from ekf_vio_tpu import engine
    from ekf_vio_tpu.sim import rendered

    seq = rendered.generate(num_frames=num_frames)
    h, w = seq.frames.shape[1:]
    cam = engine.make_hashable_camera(seq.K, w, h)
    args = (jnp.asarray(seq.frames), jnp.asarray(seq.times),
            jnp.asarray(seq.imu_dt), jnp.asarray(seq.imu_gyro),
            jnp.asarray(seq.imu_accel), jnp.asarray(seq.gravity_w))
    return seq, cam, args


def bench_imu(num_frames=240):
    """Steady-state mono-inertial frames/s: IMU strapdown propagation
    between frames + vision update on the rendered sequence."""
    from ekf_vio_tpu import engine

    cfg = imu_cfg()
    _, cam, args = imu_inputs(num_frames)
    (_, outs), dt = timed(lambda: engine.run_sequence_imu(
        *args, cfg, cam, init_frames=cfg.vi_init_frames))
    tracked = np.asarray(outs.num_tracked)
    assert np.isfinite(np.asarray(outs.base_mu)).all(), "IMU pipeline NaN"
    assert tracked[5:].min() > 10, f"IMU pipeline lost tracking: {tracked}"
    return (num_frames - cfg.vi_init_frames) / dt


def bench_cpu_reference(frames, times):
    """The reference pipeline on the host CPU: OpenCV KLT/FAST (the
    reference's own calls) + dense NumPy EKF with the same state layout
    and update equations."""
    import cv2

    from baselines.cpu_reference import CPUReferencePipeline

    s = 4
    small = [cv2.resize(f, (W_IN // s, H_IN // s)) for f in frames]
    pipe = CPUReferencePipeline(
        fx=458.0 / s, fy=458.0 / s, cx=W_IN / s / 2, cy=H_IN / s / 2,
        num_features=100, min_dist=8.0, fast_threshold=30)
    pipe.add_frame(small[0], float(times[0]))
    t0 = time.time()
    for f, t in zip(small[1:], times[1:]):
        pipe.add_frame(f, float(t))
    dt = time.time() - t0
    return (len(small) - 1) / dt


def main():
    import ekf_vio_tpu

    ekf_vio_tpu.enable_compile_cache()
    device = require_gpu()
    card = nvidia_smi()

    from ekf_vio_tpu.frontend import klt

    frames, times = make_frames()
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            cpu_fps = json.load(f)["cpu_fps"]
        baseline_origin = ("cached in baseline_cpu.json by an earlier run, "
                           "possibly on another host; not measured in this run")
    else:
        cpu_fps = bench_cpu_reference(frames, times)
        with open(BASELINE_CACHE, "w") as f:
            json.dump({"cpu_fps": cpu_fps, "note":
                       "reference pipeline (OpenCV KLT/FAST + NumPy EKF) on host CPU"},
                      f)
        baseline_origin = "measured in this run on this host's CPU"

    vis_fps = bench_vision(frames, times)
    imu_fps = bench_imu()
    batch16_fps = bench_batched(frames, times, batch=16)
    fwi_fps, fwi_tracked = bench_fwi(frames, times)

    vcfg, fcfg = vision_cfg(), fwi_cfg()
    out = {
        "metric": "vio_pipeline_frames_per_s",
        "value": vis_fps,
        "unit": "frames/s (640x480 in, /4 processed, 100 features, 1 GPU)",
        "vs_baseline": vis_fps / cpu_fps,
        "baseline_cpu_fps": cpu_fps,
        "baseline_origin": baseline_origin,
        "mono_inertial_fps": imu_fps,
        "batch16_aggregate_fps": batch16_fps,
        "batch16_speedup": batch16_fps / vis_fps,
        "fast_with_insight_fps": fwi_fps,
        "fast_with_insight_mean_tracked": fwi_tracked,
        "tracker_backend": klt.selected_backend(
            (H_IN // vcfg.inverse_image_scale, W_IN // vcfg.inverse_image_scale),
            vcfg.max_features, vcfg),
        "fast_with_insight_tracker_backend": klt.selected_backend(
            (H_IN // fcfg.inverse_image_scale, W_IN // fcfg.inverse_image_scale),
            fcfg.max_features, fcfg),
        "device": device,
        "card": card,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
