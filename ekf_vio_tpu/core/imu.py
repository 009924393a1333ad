"""IMU-driven state propagation — the capability the reference declares
but never implements.

The reference subscribes to IMU messages and then only logs the timestamp
(reference: EKFVIO.cpp:113-115; `imu_update_buffer` is declared at
EKFVIO.h:59-64 and never touched) — ω and a are random-walk states steered
purely by vision.  This module closes that gap with a real strapdown
propagation in the *same 22-state layout*, so the vision-only mode remains
bit-compatible with the reference behavior (use_imu=False).

Model: the gyro/accel measurements act as control inputs through the bias
states:

    ω      = ω_m − b_g                        (body rate)
    a_body = (a_m − b_a) + R(q)ᵀ g_w          (kinematic acceleration)

substituted into the reference kinematics (convolve_base_state /
convolve_feature), which makes the bias columns of F couple into pose,
velocity and every feature — exactly the observability structure the
reference's identity bias rows lack (TightlyCoupledEKF.cpp:255-257).

Covariance propagates as  P' = F P Fᵀ + G Q_imu Gᵀ  per IMU sample, with
F = ∂f/∂x and G = ∂f/∂n over the noise vector n = [n_g, n_a, n_bg, n_ba]
— both exact via jacfwd (closed-form autodiff of an analytic model; no
finite differences anywhere).  A camera interval's IMU batch (EuRoC:
~10 samples at 200 Hz between 20 Hz frames) is one lax.scan.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ekf_vio_tpu.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu.core import dynamics, lie
from ekf_vio_tpu.core.state import FilterState


class ImuSample(NamedTuple):
    dt: jnp.ndarray      # [..] seconds since previous sample
    gyro: jnp.ndarray    # [.., 3] rad/s
    accel: jnp.ndarray   # [.., 3] m/s² (specific force)


def substitute_imu_controls(base_mu, gyro_m, accel_m, gravity_w):
    """Replace the ω and a states with their IMU-derived values."""
    q = base_mu[3:7]
    b_acc = base_mu[16:19]
    b_gyr = base_mu[19:22]
    omega = gyro_m - b_gyr
    a_body = (accel_m - b_acc) + lie.quat_rotate(lie.quat_conj(q), gravity_w)
    return base_mu.at[10:13].set(omega).at[13:16].set(a_body)


def convolve_base_imu(base_mu, gyro_m, accel_m, dt, gravity_w):
    """One strapdown step of the base state under IMU controls.

    The propagated ω/a slots hold the IMU-derived values so the camera-
    frame feature transport (convolve_feature) and any vision update see
    a consistent state.
    """
    mu2 = substitute_imu_controls(base_mu, gyro_m, accel_m, gravity_w)
    return dynamics.convolve_base_state(mu2, dt)


def _f_with_noise(base_mu, gyro_m, accel_m, noise, dt, gravity_w):
    """Propagation with additive noise injections (for G = ∂f/∂n).

    n = [n_g(3), n_a(3), n_bg(3), n_ba(3)] — measurement white noise and
    bias random walks."""
    n_g, n_a, n_bg, n_ba = noise[0:3], noise[3:6], noise[6:9], noise[9:12]
    mu = base_mu.at[16:19].add(n_ba * dt).at[19:22].add(n_bg * dt)
    return convolve_base_imu(mu, gyro_m + n_g, accel_m + n_a, dt, gravity_w)


_jac_base_imu = jax.jacfwd(convolve_base_imu, argnums=0)
_jac_noise = jax.jacfwd(_f_with_noise, argnums=3)


def imu_noise_psd(cfg: VIOConfig) -> jnp.ndarray:
    """Diagonal continuous-time noise PSD for n = [n_g, n_a, n_bg, n_ba]."""
    return jnp.concatenate(
        [
            jnp.full((3,), cfg.imu_gyro_noise**2),
            jnp.full((3,), cfg.imu_accel_noise**2),
            jnp.full((3,), cfg.imu_gyro_bias_walk**2),
            jnp.full((3,), cfg.imu_accel_bias_walk**2),
        ]
    )


def extend_batch_with_remainder(batch: ImuSample, rem) -> ImuSample:
    """Append one zero-order-hold sample covering a camera-interval
    remainder not spanned by IMU data: the last valid sample's gyro/accel
    persisted over ``rem`` seconds.  With rem = 0 the appended row is
    dt=0 padding — an exact no-op under the compound propagation — so
    callers need no branch around it."""
    k = batch.dt.shape[0]
    valid = batch.dt > 0
    idx = jnp.maximum(jnp.max(jnp.where(valid, jnp.arange(k), -1)), 0)
    rem = jnp.where(rem > 1e-6, rem, 0.0)
    return ImuSample(
        dt=jnp.concatenate([batch.dt, rem[None]]),
        gyro=jnp.concatenate([batch.gyro, batch.gyro[idx][None]]),
        accel=jnp.concatenate([batch.accel, batch.accel[idx][None]]),
    )


def propagate_imu_step(state: FilterState, cfg: VIOConfig, sample: ImuSample,
                       gravity_w) -> FilterState:
    """One IMU sample: exact F/G, blocked P' = FPFᵀ + GQGᵀ.

    Features are transported with the IMU-substituted kinematics (their
    Jacobian blocks see the bias coupling through the substituted state)."""
    dt = sample.dt
    mu_sub = substitute_imu_controls(state.base_mu, sample.gyro, sample.accel,
                                     gravity_w)

    # F: base block w.r.t. the *original* state (bias coupling included).
    Fb = _jac_base_imu(state.base_mu, sample.gyro, sample.accel, dt, gravity_w)

    # Feature blocks: transport uses the substituted kinematic state; the
    # chain rule back to the original state runs through the substitution.
    def feat_transport(b_mu, f_mu):
        return dynamics.convolve_feature(
            substitute_imu_controls(b_mu, sample.gyro, sample.accel, gravity_w),
            f_mu, dt)

    Ffb = jax.vmap(jax.jacfwd(feat_transport, argnums=0), in_axes=(None, 0))(
        state.base_mu, state.feat_mu)
    Ff = jax.vmap(jax.jacfwd(feat_transport, argnums=1), in_axes=(None, 0))(
        state.base_mu, state.feat_mu)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)

    # G Q Gᵀ folded into the additive term: G is [22, 12]; features have
    # no direct noise input beyond their small transport noise.
    G = _jac_noise(state.base_mu, sample.gyro, sample.accel,
                   jnp.zeros(12), dt, gravity_w)
    Qn = jnp.diag(imu_noise_psd(cfg).astype(state.Sigma.dtype) / jnp.maximum(dt, 1e-6))
    GQG = G @ Qn @ G.T  # [22, 22]

    q_feat = jnp.where(state.active[:, None], cfg.q_feature, 0.0) * jnp.ones(
        (state.n_max, 3)) * dt
    q_diag = jnp.concatenate([jnp.zeros(BASE_STATE_SIZE), q_feat.reshape(-1)])

    Sigma = dynamics.propagate_covariance(
        state.Sigma, Fb, Ffb, Ff, q_diag.astype(state.Sigma.dtype))
    Sigma = Sigma.at[:BASE_STATE_SIZE, :BASE_STATE_SIZE].add(GQG)
    Sigma = 0.5 * (Sigma + Sigma.T)

    new_feat = dynamics.convolve_features(mu_sub, state.feat_mu, dt)
    feat_mu = jnp.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(mu_sub, dt)

    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma,
                         t=state.t + dt)


def propagate_imu_batch_steps(state: FilterState, cfg: VIOConfig,
                              batch: ImuSample, gravity_w) -> FilterState:
    """Reference path: scan per-sample full-state propagations (one
    [D,D] covariance triple product per IMU sample).  Kept as the ground
    truth the compound path is tested against."""

    def body(s, smp):
        dt_ok = smp.dt > 0
        s2 = propagate_imu_step(s, cfg, smp, gravity_w)
        s = jax.tree.map(lambda a, b: jnp.where(dt_ok, b, a), s, s2)
        return s, None

    state, _ = jax.lax.scan(body, state, batch)
    return state


# --------------------------------------------------------------------------
# Compound propagation — one [D,D] covariance product per camera frame.
#
# Feature transport is the action of the inter-frame camera motion on
# [u, v, ρ], and actions compose: transporting through K IMU samples equals
# transporting once by the compound motion (qc, tc).  So the whole interval
# reduces to a scan over a tiny 29-dim system x = [base(22), qc(4), tc(3)]
# that accumulates the exact chain-rule Jacobian J = ∏ J_i [29,29] and the
# noise covariance Q29 ← J_i Q29 J_iᵀ + G_i Q G_iᵀ, followed by ONE blocked
# Σ ← FΣFᵀ + Q with
#
#     Fb  = J[:22,:22],   Ffb_i = (∂T_i/∂(qc,tc)) J[22:,:22],
#     Ff_i = ∂T_i/∂feat_i,
#
# and the IMU noise reaching features exactly through the rank-7 factor
# W = ∂T/∂(qc,tc): Qff = W Q29_qt Wᵀ.  At EuRoC rates (~10 samples / frame,
# 128 slots) this is ~8x faster than per-sample propagation and agrees with
# it to float tolerance (same linearized system in different coordinates).
# --------------------------------------------------------------------------


def _motion_step29(x29, gyro_m, accel_m, noise, dt, gravity_w):
    """One IMU sample of the [base, qc, tc] system (with noise inputs)."""
    base, qc, tc = x29[0:22], x29[22:26], x29[26:29]
    n_g, n_a, n_bg, n_ba = noise[0:3], noise[3:6], noise[6:9], noise[9:12]
    base = base.at[16:19].add(n_ba * dt).at[19:22].add(n_bg * dt)
    mu_sub = substitute_imu_controls(base, gyro_m + n_g, accel_m + n_a,
                                     gravity_w)
    vel, omega, acc = mu_sub[7:10], mu_sub[10:13], mu_sub[13:16]
    dq_inv = lie.quat_conj(lie.quat_exp_omega(omega, dt))
    d = dt * vel + 0.5 * dt * dt * acc
    qc2 = lie.quat_mul(dq_inv, qc)               # compound: T_i ∘ T_{1..i-1}
    tc2 = lie.quat_rotate(dq_inv, tc - d)
    base2 = dynamics.convolve_base_state(mu_sub, dt)
    return jnp.concatenate([base2, qc2, tc2])


_jac29_x = jax.jacfwd(_motion_step29, argnums=0)
_jac29_n = jax.jacfwd(_motion_step29, argnums=3)
# fused J/G: ONE jacfwd over the concatenated [x29 | noise] input — the
# same 41 forward tangents, but a single primal trace instead of two
# (halves the phase-2 graph; measured compile + runtime win)
_jac29_xn = jax.jacfwd(
    lambda xn, gyro, accel, dt, g_w: _motion_step29(
        xn[:29], gyro, accel, xn[29:], dt, g_w))


def _compound_transport(feat_mu, qt):
    """Transport [u, v, ρ] by the compound motion qt = [qc(4), tc(3)]."""
    z = 1.0 / feat_mu[2]
    p = jnp.array([feat_mu[0] * z, feat_mu[1] * z, z])
    p = lie.quat_rotate(qt[0:4], p) + qt[4:7]
    return jnp.array([p[0] / p[2], p[1] / p[2], 1.0 / p[2]])


_transport_jac_feat = jax.vmap(jax.jacfwd(_compound_transport, argnums=0),
                               in_axes=(0, None))
_transport_jac_qt = jax.vmap(jax.jacfwd(_compound_transport, argnums=1),
                             in_axes=(0, None))


def _compose_chain_tree(Ji, Qi):
    """Compound a chain of (J, Q) covariance-transport pairs by a pairwise
    reduction tree.

    Ji: [K, n, n] per-sample transition Jacobians (applied in index order:
    sample 0 first), Qi: [K, n, n] per-sample additive noise.  Returns the
    compound (J = J_{K-1}···J_0, Q) — identical algebra to the sequential
    left fold, reassociated into log₂K levels of batched matmuls.
    """
    while Ji.shape[0] > 1:
        k = Ji.shape[0]
        even = k - (k % 2)
        Ja, Qa = Ji[0:even:2], Qi[0:even:2]     # earlier of each pair
        Jb, Qb = Ji[1:even:2], Qi[1:even:2]     # later of each pair
        Jc = jnp.einsum("kij,kjl->kil", Jb, Ja)
        Qc = jnp.einsum("kij,kjl,kml->kim", Jb, Qa, Jb) + Qb
        if k % 2:
            Jc = jnp.concatenate([Jc, Ji[-1:]], 0)
            Qc = jnp.concatenate([Qc, Qi[-1:]], 0)
        Ji, Qi = Jc, Qc
    return Ji[0], Qi[0]


def propagate_imu_batch(state: FilterState, cfg: VIOConfig, batch: ImuSample,
                        gravity_w) -> FilterState:
    """Propagate a camera interval's IMU samples ([K] leading dim;
    zero-dt rows are padding and become no-ops) with one covariance
    propagation for the whole interval (see block comment above)."""
    state, _ = propagate_imu_batch_with_motion(state, cfg, batch, gravity_w)
    return state


def _mean_chain(x0, batch: ImuSample, gravity_w):
    """Closed-form mean integration of the 29-dim [base, qc, tc] system
    over a camera interval — the exact algebra of scanning
    ``_motion_step29`` with zero noise, reassociated into batched ops with
    O(log K) sequential depth.  The sequential scan was the latency floor
    of the mono-inertial step (~200 dependent scalar-vector ops, each too
    small to fill the device).

    Derivation: with w_i = R(q_i) v_i (world velocity) and
    A_i = R(q_i)(accel_i − b_a) + g_w (world acceleration), the
    body-frame recursions of convolve_base_state collapse to prefix sums

        q_i  = q_0 ⊗ dq_0 ⊗ … ⊗ dq_{i-1}      (cumulative quat product)
        w_{i+1} = w_i + dt_i A_i                           (cumsum)
        p_{i+1} = p_i + dt_i w_i + ½ dt_i² A_i             (cumsum)
        R(q_i) tc_i = p_0 − p_i,   qc_i = (dq_0 ⊗ … ⊗ dq_{i-1})*

    Returns (x_final [29], xs [K, 29]) with xs_j the state BEFORE sample
    j — what the covariance-transport Jacobians linearize at.  Zero-dt
    rows are exact no-ops (dq = identity, zero increments), so padding
    anywhere in the batch is handled.
    """
    dt = batch.dt
    k = dt.shape[0]
    dtype = x0.dtype
    p0, q0, v0 = x0[0:3], x0[3:7], x0[7:10]
    b_a, b_g = x0[16:19], x0[19:22]

    omega = batch.gyro - b_g                           # [K, 3]
    dq = lie.quat_exp_omega(omega, dt[:, None])        # [K, 4]; id at dt=0

    # cumulative orientation increments c_i = dq_0 ⊗ … ⊗ dq_i (log depth)
    c = jax.lax.associative_scan(lie.quat_mul, dq)     # [K, 4]
    ident = jnp.concatenate([jnp.ones((1,), dtype), jnp.zeros((3,), dtype)])
    c_excl = jnp.concatenate([ident[None], c[:-1]], 0)
    q_pre = lie.quat_mul(q0[None], c_excl)             # [K, 4]
    q_pre_inv = lie.quat_conj(q_pre)

    A = lie.quat_rotate(q_pre, batch.accel - b_a) + gravity_w[None]
    dv = dt[:, None] * A
    w0 = lie.quat_rotate(q0, v0)
    w_pre = w0[None] + jnp.cumsum(dv, 0) - dv          # exclusive prefix
    D = dt[:, None] * w_pre + 0.5 * (dt * dt)[:, None] * A
    p_pre = p0[None] + jnp.cumsum(D, 0) - D

    v_pre = lie.quat_rotate(q_pre_inv, w_pre)
    qc_pre = lie.quat_conj(c_excl)
    tc_pre = lie.quat_rotate(q_pre_inv, p0[None] - p_pre)

    # ω/a state slots of the PRE states: the control substitution
    # overwrites both before any use inside the step, so their xs values
    # never enter the Jacobians; carry x0's slots through
    om_slot = jnp.broadcast_to(x0[10:13], (k, 3))
    ac_slot = jnp.broadcast_to(x0[13:16], (k, 3))
    bias = jnp.broadcast_to(x0[16:22], (k, 6))
    xs = jnp.concatenate(
        [p_pre, q_pre, v_pre, om_slot, ac_slot, bias, qc_pre, tc_pre], -1)

    # final state (after the last valid sample)
    q_fin = lie.quat_mul(q0, c[-1])
    q_fin_inv = lie.quat_conj(q_fin)
    w_fin = w0 + jnp.sum(dv, 0)
    p_fin = p0 + jnp.sum(D, 0)
    v_fin = lie.quat_rotate(q_fin_inv, w_fin)
    qc_fin = lie.quat_conj(c[-1])
    tc_fin = lie.quat_rotate(q_fin_inv, p0 - p_fin)

    # ω/a slots after the interval: the last valid sample's substituted
    # rate and its dq⁻¹-transported acceleration (convolve_base_state
    # semantics); an all-padding interval keeps x0's slots
    valid = dt > 0
    last = jnp.max(jnp.where(valid, jnp.arange(k), -1))
    has = last >= 0
    idx = jnp.maximum(last, 0)
    a_pre = (batch.accel - b_a
             + lie.quat_rotate(q_pre_inv,
                               jnp.broadcast_to(gravity_w, (k, 3))))
    a_post = lie.quat_rotate(lie.quat_conj(dq), a_pre)
    om_fin = jnp.where(has, omega[idx], x0[10:13])
    ac_fin = jnp.where(has, a_post[idx], x0[13:16])

    x_fin = jnp.concatenate(
        [p_fin, q_fin, v_fin, om_fin, ac_fin, x0[16:22], qc_fin, tc_fin])
    return x_fin, xs


@jax.default_matmul_precision("float32")
def compound_interval(base_mu, cfg: VIOConfig, batch: ImuSample, gravity_w,
                      dtype, lin_base=None):
    """Phases 1-3 of the compound propagation (shared by the dense and the
    sharded filter): integrate the 29-dim [base, qc, tc] system over the
    interval and compound the per-sample (J, Q) transport pairs.

    Returns (base_mu', qt, qt_lin, J [29,29], Q29 [29,29], total_dt) where
    qt_lin is the compound motion of the FEJ linearization chain (== qt
    when ``lin_base`` is None).
    """
    psd = imu_noise_psd(cfg).astype(dtype)

    x0 = jnp.concatenate(
        [base_mu, jnp.array([1.0, 0, 0, 0], dtype), jnp.zeros(3, dtype)])

    # Phase 1 — closed-form mean chain (_mean_chain): one cumulative
    # quaternion product + world-frame prefix sums instead of a K-step
    # sequential scan.  With FEJ the linearization chain is a second vmap
    # lane over the same batched ops.
    k = batch.dt.shape[0]
    if lin_base is None:
        x, xs = _mean_chain(x0, batch, gravity_w)
        xs_lin, x_lin = xs, x
    else:
        x0_lin = jnp.concatenate(
            [lin_base.astype(dtype), jnp.array([1.0, 0, 0, 0], dtype),
             jnp.zeros(3, dtype)])
        xf2, xs2 = jax.vmap(_mean_chain, in_axes=(0, None, None))(
            jnp.stack([x0, x0_lin]), batch, gravity_w)
        x, x_lin = xf2[0], xf2[1]
        xs, xs_lin = xs2[0], xs2[1]

    # Phase 2 — per-sample Jacobians, batched over the whole interval
    # (sequentializing these inside the scan is 2.5x slower on hardware);
    # J and G come from ONE fused jacfwd over [x | n].
    xn = jnp.concatenate(
        [xs_lin, jnp.zeros((k, 12), dtype)], axis=-1)          # [K, 41]
    JG = jax.vmap(_jac29_xn, in_axes=(0, 0, 0, 0, None))(
        xn, batch.gyro, batch.accel, batch.dt, gravity_w)      # [K, 29, 41]
    Ji = JG[:, :, :29]
    Gi = JG[:, :, 29:]
    qn = psd[None, :] / jnp.maximum(batch.dt, 1e-6)[:, None]
    GQG = jnp.einsum("kij,kj,klj->kil", Gi, qn, Gi)
    ok = (batch.dt > 0)[:, None, None]
    Ji = jnp.where(ok, Ji, jnp.eye(29, dtype=dtype)[None])
    GQG = jnp.where(ok, GQG, 0.0)

    # Phase 3 — compose (J, Q) pairs: associative, so a log-depth pairwise
    # tree of batched matmuls instead of K sequential 29×29 products.
    J, Q29 = _compose_chain_tree(Ji, GQG)

    return x[0:22], x[22:29], x_lin[22:29], J, Q29, jnp.sum(batch.dt)


@jax.default_matmul_precision("float32")
def propagate_imu_batch_with_motion(state: FilterState, cfg: VIOConfig,
                                    batch: ImuSample, gravity_w,
                                    lin_base=None):
    """As propagate_imu_batch, also returning the compound camera motion
    qt = [qc(4), tc(3)] of the interval (p_cur = R(qc) p_prev + tc) — the
    exact inter-frame baseline, needed e.g. by two-view depth
    triangulation (the dt·vel reconstruction the vision-only mode uses is
    wrong under IMU propagation).

    ``lin_base`` (first-estimate Jacobians): when given (the base state
    as predicted at the PREVIOUS frame, before its vision update), the
    covariance-transport Jacobians Ji/Gi are evaluated along a chain
    propagated from ``lin_base`` instead of the posterior mean.  With
    posterior linearization points, consecutive transition Jacobians
    chain at mismatched states, which makes the filter's observability
    Gramian gain rank along the yaw-about-gravity direction that the
    true system cannot observe — the classic EKF-VIO inconsistency
    (Huang et al., FEJ).  The dynamics here are exactly equivariant
    under world yaw (gravity compensation R(q)ᵀg_w is invariant, body
    velocities are frame-local, features are camera-frame), so pinning
    the Jacobian chain to prior estimates preserves the unobservable
    subspace to first order; the mean always uses the best estimate.
    """
    nb = BASE_STATE_SIZE
    dtype = state.Sigma.dtype

    base_mu, qt, qt_lin, J, Q29, total_dt = compound_interval(
        state.base_mu, cfg, batch, gravity_w, dtype, lin_base=lin_base)

    # Jacobian blocks of the compound map (analytic batched einsums; the
    # vmapped-jacfwd equivalent is kept above as the tested ground truth).
    # FEJ coverage: with lin_base given, the feature-transport Jacobians
    # W/Ff are ALSO evaluated at the first-estimate compound motion
    # qt_lin (the lin chain's endpoint) so the whole column of F chains at
    # matched linearization points; only the feature coordinates
    # themselves still linearize at their posterior values (their prior
    # is not retained — a deliberate partial coverage, the correction is
    # O(innovation) per frame).  The MEAN transport always uses the best
    # (posterior) estimate qt.
    Fb = J[:nb, :nb]
    new_feat = jax.vmap(_compound_transport, in_axes=(0, None))(
        state.feat_mu, qt)
    _, Ff, W = dynamics.transport_jacobians(state.feat_mu, qt_lin)
    Ffb = jnp.einsum("nij,jb->nib", W, J[nb:, :nb])       # [N, 3, 22]
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    W = jnp.where(state.active[:, None, None], W, 0.0)

    q_feat = jnp.where(state.active[:, None], cfg.q_feature, 0.0) * jnp.ones(
        (state.n_max, 3), dtype) * total_dt
    q_diag = jnp.concatenate([jnp.zeros(nb, dtype), q_feat.reshape(-1)])

    Sigma = dynamics.propagate_covariance(state.Sigma, Fb, Ffb, Ff, q_diag)

    # Accumulated IMU noise: base block, rank-7 feature block, and cross.
    Wm = W.reshape(3 * state.n_max, 7)
    Qbf = Q29[:nb, nb:] @ Wm.T                            # [22, 3N]
    Sigma = Sigma.at[:nb, :nb].add(Q29[:nb, :nb])
    Sigma = Sigma.at[:nb, nb:].add(Qbf)
    Sigma = Sigma.at[nb:, :nb].add(Qbf.T)
    Sigma = Sigma.at[nb:, nb:].add(Wm @ Q29[nb:, nb:] @ Wm.T)
    Sigma = 0.5 * (Sigma + Sigma.T)

    feat_mu = jnp.where(state.active[:, None], new_feat, state.feat_mu)

    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma,
                         t=state.t + total_dt), qt


def estimate_gravity_world(accel_samples: jnp.ndarray, g: float = 9.81):
    """Initial gravity in the world (= initial body) frame from a
    stationary window: specific force at rest is f = −g_w."""
    mean_f = jnp.mean(accel_samples, axis=0)
    return -mean_f / jnp.linalg.norm(mean_f) * g
