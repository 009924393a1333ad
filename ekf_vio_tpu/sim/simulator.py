"""Closed-loop synthetic simulator — the primary correctness harness.

Reproduces the semantics of the reference's simulation driver
(reference: test/analyzeEKFSimulation.cpp:10-151): a seeded random scene
of 3D points in front of the camera, ground-truth kinematics advanced with
the *same* motion model as the filter, and noiseless projected
measurements with constant covariance diag(1e-5) fed back into the update.
This exercises the full predict/update math with no image pipeline.

The whole rollout is one ``lax.scan`` over time, jitted end to end; scenario generation uses ``jax.random`` with fixed seeds.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.core import filter as ekf
from ekf_vio_tpu.core import lie


class Scenario(NamedTuple):
    feature_count: int
    depth_sigma: float
    depth_mu: float
    b_vel: tuple
    b_accel: tuple
    omega: tuple
    dt: float
    tf: float


# The six scenarios of increasing difficulty run by the reference driver
# (test/analyzeEKFSimulation.cpp:232-244).
REFERENCE_SCENARIOS = [
    Scenario(30, 1e-6, 0.5, (0.5, 0, 0), (0, 0, 0), (0, 0, 0), 0.05, 0.5),
    Scenario(30, 1e-6, 0.5, (0.1, 0, -0.1), (0, 0, 0), (0, 0, 0.1), 0.05, 5.0),
    Scenario(30, 1e-6, 0.5, (0, 0, -0.1), (0, 0, 0), (0, 0, 0.1), 0.05, 5.0),
    Scenario(30, 0.01, 0.5, (0, 0, -0.1), (0, 0, 0), (0, 0, 0.1), 0.05, 5.0),
    Scenario(30, 0.01, 0.5, (-0.1, 0, -0.1), (0, 0, 0), (0, 0.1, 0), 0.05, 5.0),
    Scenario(100, 0.01, 0.5, (-0.1, 0, -0.1), (0, 0, 0), (0, 0.1, 0), 0.05, 5.0),
]


def generate_scene(key, scn: Scenario, n_max: int):
    """Random points: depth ~ N(mu, sigma), u,v ~ U(-1.5, 1.5)·z
    (analyzeEKFSimulation.cpp:11-29), padded to n_max slots."""
    kz, kuv = jax.random.split(key)
    z = scn.depth_mu + scn.depth_sigma * jax.random.normal(kz, (n_max,))
    uv = jax.random.uniform(kuv, (n_max, 2), minval=-1.5, maxval=1.5) * z[:, None]
    pts = jnp.concatenate([uv, z[:, None]], axis=-1)  # [N, 3] camera-frame points
    valid = jnp.arange(n_max) < scn.feature_count
    return pts, valid


def project(points_w, pos, quat):
    """Project world points into the camera at (pos, quat): the fake
    measurement generator (analyzeEKFSimulation.cpp:101-125)."""
    qi = lie.quat_conj(quat)
    p_cam = lie.quat_rotate(qi, points_w) - lie.quat_rotate(qi, pos)[None]
    return p_cam[:, :2] / p_cam[:, 2:3]


class GroundTruth(NamedTuple):
    pos: jnp.ndarray
    quat: jnp.ndarray
    vel: jnp.ndarray
    accel: jnp.ndarray


def advance_ground_truth(gt: GroundTruth, omega, dt) -> GroundTruth:
    """Advance GT kinematics with the same motion model as the filter
    (analyzeEKFSimulation.cpp:57-84)."""
    pos = gt.pos + lie.quat_rotate(gt.quat, dt * gt.vel + 0.5 * dt * dt * gt.accel)
    dq = lie.quat_exp_omega(omega, dt)
    dqi = lie.quat_conj(dq)
    vel = lie.quat_rotate(dqi, gt.vel + dt * gt.accel)
    accel = lie.quat_rotate(dqi, gt.accel)
    quat = lie.quat_mul(gt.quat, dq)
    return GroundTruth(pos, quat, vel, accel)


@partial(jax.jit, static_argnames=("scn", "cfg", "num_steps"))
def run_scenario(key, scn: Scenario, cfg: VIOConfig, num_steps: int):
    """Jitted closed-loop rollout. Returns final state + per-step telemetry."""
    pts_cam0, valid = generate_scene(key, scn, cfg.max_features)

    state = ekf.init_state(cfg)
    state = ekf.add_features(state, cfg, pts_cam0[:, :2] / pts_cam0[:, 2:3], valid)

    omega = jnp.asarray(scn.omega, jnp.float32)
    gt0 = GroundTruth(
        pos=jnp.zeros(3),
        quat=jnp.array([1.0, 0, 0, 0]),
        vel=jnp.asarray(scn.b_vel, jnp.float32),
        accel=jnp.asarray(scn.b_accel, jnp.float32),
    )

    meas_cov = jnp.tile(jnp.eye(2) * 1e-5, (cfg.max_features, 1, 1))

    # square-root mode runs the loop factor-native (round 4): factor once
    # here, never re-square inside the scan — the state carries L
    sq = cfg.square_root_form
    if sq:
        from ekf_vio_tpu.core import sqrt_filter

        state = sqrt_filter.to_factor(state)

    def step(carry, _):
        state, gt = carry
        if sq:
            state = sqrt_filter.predict_sqrt_factor(state, cfg, scn.dt)
        else:
            state = ekf.predict(state, cfg, scn.dt)
        gt = advance_ground_truth(gt, omega, scn.dt)
        z = project(pts_cam0, gt.pos, gt.quat)
        if sq:
            state = sqrt_filter.update_sqrt_factor(state, cfg, z, meas_cov,
                                                   valid)
            # telemetry in factor space: diag(LLᵀ) = row norms ≥ 0 by
            # construction; LLᵀ is exactly symmetric
            min_diag = jnp.min(sqrt_filter.sigma_diag_factor(state.Sigma))
            asym = jnp.float32(0.0)
        else:
            state = ekf.update_with_feature_positions(state, cfg, z,
                                                      meas_cov, valid)
            min_diag, asym = ekf.check_sigma(state)
        pos_err = jnp.linalg.norm(state.base_mu[0:3] - gt.pos)
        feat_err = jnp.sum(
            jnp.where(valid, jnp.linalg.norm(state.feat_mu[:, :2] - z, axis=-1), 0.0)
        ) / jnp.maximum(jnp.sum(valid), 1)
        return (state, gt), (min_diag, asym, pos_err, feat_err)

    (state, gt), telem = jax.lax.scan(step, (state, gt0), None, length=num_steps)
    if sq:  # callers receive a dense Σ at the API boundary
        state = sqrt_filter.to_covariance(state)
    return state, gt, telem


def run_reference_scenarios(cfg: VIOConfig | None = None, seed: int = 0):
    """Run all six reference scenarios; returns list of (scenario, telemetry)."""
    results = []
    for i, scn in enumerate(REFERENCE_SCENARIOS):
        c = (cfg or VIOConfig()).replace(max_features=max(scn.feature_count, 32))
        num_steps = int(round(scn.tf / scn.dt))
        key = jax.random.PRNGKey(seed + i)
        state, gt, telem = run_scenario(key, scn, c, num_steps)
        results.append((scn, state, gt, telem))
    return results
