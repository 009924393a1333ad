"""End-to-end trajectory-accuracy benchmark on the rendered sequence.

Stands in for the EuRoC ATE evaluation in this zero-egress environment
(BASELINE.json config 3): a textured-plane scene with an exact analytic
trajectory and IMU stream (sim/rendered.py) run through the FULL stack
(pyramid → FAST → KLT → EKF), scored with Umeyama-aligned ATE RMSE
(io/trajectory.py — the standard monocular protocol).

Writes results/ate.json.  Run on a GPU: python benchmarks/ate_bench.py
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ekf_vio_tpu.config import VIOConfig  # noqa: E402
from ekf_vio_tpu.sim import rendered  # noqa: E402


def main():
    import bench
    import ekf_vio_tpu

    ekf_vio_tpu.enable_compile_cache()
    device = bench.require_gpu()
    seq = rendered.generate(num_frames=300)
    path_len = float(np.sum(np.linalg.norm(np.diff(seq.gt_pos, axis=0), axis=1)))
    cfg = VIOConfig(max_features=128, min_new_feature_dist=10.0,
                    fast_threshold=25, triangulate_new_features=True,
                    klt_measurement_variance_px=0.001, q_feature=1e-7)

    from ekf_vio_tpu.frontend import klt
    h, w = seq.frames.shape[1:]
    backend = klt.selected_backend((h, w), cfg.max_features, cfg)

    report = {"device": device, "card": bench.nvidia_smi(),
              "tracker_backend": backend,
              "sequence": "rendered plane, 300 frames @20fps, 320x240",
              "path_length_m": round(path_len, 3)}
    for name, use_imu in (("mono_inertial", True), ("vision_only", False)):
        t0 = time.time()
        ate, outs = rendered.evaluate_ate(seq, cfg=cfg, use_imu=use_imu)
        wall_first = time.time() - t0
        # second call: jit cache warm → pure run time; the difference is
        # the compile cost (tracked per VERDICT r3 #8 — with the
        # persistent compilation cache, repeat processes pay run_s too)
        t0 = time.time()
        ate, outs = rendered.evaluate_ate(seq, cfg=cfg, use_imu=use_imu)
        run_s = time.time() - t0
        report[f"{name}_ate_rmse_m"] = round(float(ate), 5)
        report[f"{name}_ate_pct_path"] = round(100 * float(ate) / path_len, 3)
        report[f"{name}_mean_tracked"] = round(
            float(np.mean(np.asarray(outs.num_tracked))), 1)
        report[f"{name}_wall_s"] = round(wall_first, 1)
        report[f"{name}_run_s"] = round(run_s, 1)
        report[f"{name}_compile_s"] = round(wall_first - run_s, 1)

    # the reference's high-feature operating point (configs/
    # fast_with_insight.yaml mirror of params/fast_with_insight.yaml):
    # 400 features / 512 slots on the same rendered scene (already 320x240
    # = the profile's ÷2 processed size), vision-only like the profile
    fwi = VIOConfig.from_yaml(
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "fast_with_insight.yaml"))
    fwi = fwi.replace(min_new_feature_dist=8.0, fast_threshold=25,
                      klt_measurement_variance_px=0.05)
    backend_fwi = klt.selected_backend((h, w), fwi.max_features, fwi)
    t0 = time.time()
    ate, outs = rendered.evaluate_ate(seq, cfg=fwi, use_imu=False)
    report["fast_with_insight_ate_rmse_m"] = round(float(ate), 5)
    report["fast_with_insight_ate_pct_path"] = round(
        100 * float(ate) / path_len, 3)
    report["fast_with_insight_mean_tracked"] = round(
        float(np.mean(np.asarray(outs.num_tracked))), 1)
    report["fast_with_insight_wall_s"] = round(time.time() - t0, 1)
    report["fast_with_insight_tracker_backend"] = backend_fwi

    # aggressive-motion benchmark (VERDICT r4 #5): 1.5 rad/s peak rates,
    # 32 deg yaw sweep, two-plane depth, exposure drift, features
    # continuously leaving the FOV — the handheld-rig regime.  Runs the
    # aggressive robustness profile (configs/aggressive.yaml: realistic
    # tracker noise for this regime + chi-square innovation gate +
    # relative structure gate).
    agg = rendered.generate_aggressive(num_frames=360)
    agg_path = float(np.sum(np.linalg.norm(np.diff(agg.gt_pos, axis=0), axis=1)))
    agg_cfg = VIOConfig.from_yaml(
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "aggressive.yaml"))
    report["aggressive_path_length_m"] = round(agg_path, 3)
    report["aggressive_peak_rate_rad_s"] = 1.5
    report["aggressive_profile"] = "configs/aggressive.yaml"
    for name, use_imu in (("aggressive_mono", True),
                          ("aggressive_vision", False)):
        ate, outs = rendered.evaluate_ate(agg, cfg=agg_cfg, use_imu=use_imu)
        lost = int(np.sum(np.asarray(outs.tracking_lost)))
        report[f"{name}_ate_rmse_m"] = round(float(ate), 5)
        report[f"{name}_ate_pct_path"] = round(100 * float(ate) / agg_path, 3)
        report[f"{name}_mean_tracked"] = round(
            float(np.mean(np.asarray(outs.num_tracked))), 1)
        report[f"{name}_frames_tracking_lost"] = lost

    # A/B: the reference's written-but-never-wired SSD measurement-
    # covariance estimator (KLTTracker.cpp:111-175), live as
    # klt_covariance='sample' — measured on the aggressive scene where
    # per-feature corner quality varies most.  Verdict: it HURTS (the SSD
    # response surface under perspective warp claims precision in exactly
    # the template-sliding direction), which empirically vindicates the
    # reference's own decision to leave it unwired.
    ate_ssd, outs_ssd = rendered.evaluate_ate(
        agg, cfg=agg_cfg.replace(klt_covariance="sample"), use_imu=True)
    report["aggressive_mono_ssd_covariance_ate_pct_path"] = round(
        100 * float(ate_ssd) / agg_path, 3)

    report["compile_note"] = (
        "cold-compile seconds vary +-3x with remote-compile-service "
        "contention (fresh-process probes of the identical mono program "
        "measured 24-174 s); warm (persistent cache) repeats pay run_s")
    out = bench.out_path("ate.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
