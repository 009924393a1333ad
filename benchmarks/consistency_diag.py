"""Diagnose mono-inertial filter consistency on the rendered sequence.

Compares per-frame estimation errors against the filter's own reported
covariance (pose NEES, yaw error vs yaw sigma, bias convergence) — the
tool that calibrated configs/mono_inertial.yaml's noise stack.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ekf_vio_tpu  # noqa: E402

ekf_vio_tpu.enable_compile_cache()

from ekf_vio_tpu.config import VIOConfig  # noqa: E402
from ekf_vio_tpu.sim import rendered  # noqa: E402


def main():
    num_frames = int(os.environ.get("DIAG_FRAMES", "300"))
    seq = rendered.generate(num_frames=num_frames)
    overrides = {}
    for key in ("vi_init_frames", "bootstrap_max_age", "vi_init_gn_rounds"):
        if f"DIAG_{key.upper()}" in os.environ:
            overrides[key] = int(os.environ[f"DIAG_{key.upper()}"])
    for key in ("klt_measurement_variance_px", "init_gyro_bias_sigma",
                "init_accel_bias_sigma", "init_aligned_velocity_variance",
                "q_feature", "bootstrap_depth_sigma_rel", "sigma_jitter_rel"):
        if f"DIAG_{key.upper()}" in os.environ:
            overrides[key] = float(os.environ[f"DIAG_{key.upper()}"])
    if os.environ.get("DIAG_USE_FEJ"):
        overrides["use_fej"] = bool(int(os.environ["DIAG_USE_FEJ"]))
    kw = dict(max_features=128, min_new_feature_dist=10.0,
              fast_threshold=25, triangulate_new_features=True,
              klt_measurement_variance_px=0.001, q_feature=1e-7)
    kw.update(overrides)
    cfg = VIOConfig(**kw)
    ate, outs = rendered.evaluate_ate(seq, cfg=cfg, use_imu=True)
    path_len = float(np.sum(np.linalg.norm(np.diff(seq.gt_pos, axis=0), axis=1)))

    start = cfg.vi_init_frames
    base = np.asarray(outs.base_mu)          # [T-start, 22]
    pcov = np.asarray(outs.pose_cov_diag)    # [T-start, 7]
    gt_p = seq.gt_pos[start:]
    gt_q = seq.gt_quat[start:]

    # raw (un-aligned) position error vs filter sigma
    perr = base[:, 0:3] - gt_p
    psig = np.sqrt(np.maximum(pcov[:, 0:3], 1e-12))

    # quaternion error angle
    qe = np.abs(np.sum(base[:, 3:7] * gt_q, axis=1))
    ang_err = 2 * np.arccos(np.clip(qe, 0, 1))

    # yaw about gravity: g points +y camera (world) frame
    g_dir = seq.gravity_w / np.linalg.norm(seq.gravity_w)

    def twist_angle(q):
        xyz = q[1:4]
        proj = np.dot(xyz, g_dir)
        return 2.0 * np.arctan2(proj, q[0])

    yaw_est = np.array([twist_angle(q / np.linalg.norm(q)) for q in base[:, 3:7]])
    yaw_gt = np.array([twist_angle(q) for q in gt_q])
    yaw_err = yaw_est - yaw_gt
    # yaw sigma proxy: variance of quaternion component along g (x2)
    qsig = np.sqrt(np.maximum(pcov[:, 3:7], 1e-12))

    bg_est = base[:, 19:22]
    ba_est = base[:, 16:19]
    bg_true = np.asarray(seq.gyro_bias)
    ba_true = np.asarray(seq.accel_bias)

    idx = np.linspace(0, len(base) - 1, 10).astype(int)

    # ---- pose NEES (full 3x3 position block) and innovation NIS
    # (VERDICT r4 #4: report the statistics, not just inside-the-bounds).
    # NEES_k = e_kᵀ P_k⁻¹ e_k with E[NEES] = 3; per-frame 95% band is
    # chi2_3 [0.2158, 9.3484].  NIS is the mean per-feature 2-dof
    # innovation statistic (core/update.innovation_nis), E[NIS] = 2.
    pos_cov = np.asarray(outs.pos_cov)       # [T-start, 3, 3]
    nees = np.zeros(len(base))
    for k in range(len(base)):
        P = pos_cov[k] + 1e-12 * np.eye(3)
        nees[k] = perr[k] @ np.linalg.solve(P, perr[k])
    nis = np.asarray(outs.mean_nis)
    chi3_lo, chi3_hi = 0.2158, 9.3484
    in_band = float(np.mean((nees[5:] > chi3_lo) & (nees[5:] < chi3_hi)))

    rep = {
        "ate_rmse_m": float(ate),
        "ate_pct_path": 100 * float(ate) / path_len,
        "pos_nees_mean": float(nees[5:].mean()),
        "pos_nees_t": nees[idx].round(4).tolist(),
        "pos_nees_frac_in_chi2_95_band": in_band,
        "pos_nees_expectation": 3.0,
        "nis_mean": float(nis[5:].mean()),
        "nis_t": nis[idx].round(4).tolist(),
        "nis_expectation": 2.0,
        "frames": num_frames,
        "pos_err_final_m": perr[-1].tolist(),
        "pos_sig_final_m": psig[-1].tolist(),
        "pos_err_norm_t": np.linalg.norm(perr[idx], axis=1).round(5).tolist(),
        "pos_sig_norm_t": np.linalg.norm(psig[idx], axis=1).round(5).tolist(),
        "ang_err_deg_t": np.degrees(ang_err[idx]).round(4).tolist(),
        "yaw_err_deg_t": np.degrees(yaw_err[idx]).round(4).tolist(),
        "quat_sig_t": qsig[idx].max(axis=1).round(6).tolist(),
        "bg_err_final": (bg_est[-1] - bg_true).tolist(),
        "ba_err_final": (ba_est[-1] - ba_true).tolist(),
        "bg_err_norm_t": np.linalg.norm(bg_est[idx] - bg_true, axis=1).round(5).tolist(),
        "ba_err_norm_t": np.linalg.norm(ba_est[idx] - ba_true, axis=1).round(5).tolist(),
        "vel_est_final": base[-1, 7:10].tolist(),
        "mean_tracked": float(np.mean(np.asarray(outs.num_tracked))),
    }
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
