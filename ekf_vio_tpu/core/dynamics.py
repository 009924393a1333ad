"""Process model: base-state and feature transport + exact Jacobians.

Reproduces the semantics of the reference motion model
(reference: TightlyCoupledEKF.cpp:328-460) as pure jnp functions:

* ``convolve_base_state`` — constant body-rate / body-accel kinematics:
  position advances in the world frame by the rotated body displacement,
  the incremental rotation dq comes from ω·dt, and velocity/acceleration
  are re-expressed in the *new* body frame (v ← dq⁻¹(v + a·dt), a ← dq⁻¹a);
  ω and the bias states are random walks (TightlyCoupledEKF.cpp:338-391).

* ``convolve_feature`` — features live as [u, v, ρ=1/depth] in the current
  camera frame; transport un-inverts depth, applies the inverse camera
  motion p ← dq⁻¹p − dq⁻¹(v·dt + ½a·dt²), and re-projects
  (TightlyCoupledEKF.cpp:397-460; the thread-unsafe static dq cache of the
  reference is unnecessary here — XLA CSEs the shared subexpression).

The reference linearizes this model with O(9N) central-difference
evaluations (TightlyCoupledEKF.cpp:176-325, DELTA_SHIFT=1e-3).  Here the
Jacobian is exact via ``jax.jacfwd`` + ``vmap``, and is assembled into a
dense F whose known sparsity structure (features never influence the base
state; feature rows couple only to base columns 7..15 and their own 3x3
block — TightlyCoupledEKF.cpp:191-257) is preserved by construction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ekf_vio_tpu.config import BASE_STATE_SIZE
from ekf_vio_tpu.core import lie


def convolve_base_state(base_mu: jnp.ndarray, dt) -> jnp.ndarray:
    """Propagate the 22-dim base state by dt (no noise)."""
    pos = base_mu[0:3]
    quat = base_mu[3:7]
    vel = base_mu[7:10]
    omega = base_mu[10:13]
    accel = base_mu[13:16]

    disp = dt * vel + 0.5 * dt * dt * accel
    pos = pos + lie.quat_rotate(quat, disp)

    dq = lie.quat_exp_omega(omega, dt)
    dq_inv = lie.quat_conj(dq)

    vel = lie.quat_rotate(dq_inv, vel + dt * accel)
    accel_new = lie.quat_rotate(dq_inv, accel)
    quat = lie.quat_mul(quat, dq)

    return jnp.concatenate([pos, quat, vel, omega, accel_new, base_mu[16:22]])


def convolve_feature(base_mu: jnp.ndarray, feat_mu: jnp.ndarray, dt) -> jnp.ndarray:
    """Transport one feature [u, v, ρ] into the next camera frame.

    Safe for padded (inactive) slots as long as ρ stays bounded away from 0;
    inactive slots are kept at the default-depth prior by the filter layer.
    """
    vel = base_mu[7:10]
    omega = base_mu[10:13]
    accel = base_mu[13:16]

    z = 1.0 / feat_mu[2]
    p = jnp.array([feat_mu[0] * z, feat_mu[1] * z, z])

    translation = dt * vel + 0.5 * dt * dt * accel
    dq_inv = lie.quat_conj(lie.quat_exp_omega(omega, dt))

    p = lie.quat_rotate(dq_inv, p) - lie.quat_rotate(dq_inv, translation)

    return jnp.array([p[0] / p[2], p[1] / p[2], 1.0 / p[2]])


convolve_features = jax.vmap(convolve_feature, in_axes=(None, 0, None))


# --------------------------------------------------------------------------
# Camera action (q, t) and analytic transport Jacobians
#
# Feature transport is the action of the inter-frame camera motion on
# [u, v, ρ]: with p = [u, v, 1]/ρ,  p' = R(q) p + t,  feat' = [p'x/p'z,
# p'y/p'z, 1/p'z].  Its Jacobians are closed-form batched 3x3/3x7 einsums;
# per-feature ``jacfwd`` (25 tangents × N features of tiny elementwise
# chains) measures 5-10x slower on hardware despite identical FLOPs —
# op-dispatch latency, not compute, dominates at this scale.
# --------------------------------------------------------------------------


def camera_motion_qt(base_mu, dt):
    """[7] compound camera action (q[4], t[3]) over dt: p' = R(q) p + t.

    Matches convolve_feature: q = dq⁻¹, t = −R(dq⁻¹)(dt·v + ½dt²·a)
    (TightlyCoupledEKF.cpp:449-450)."""
    vel = base_mu[7:10]
    omega = base_mu[10:13]
    accel = base_mu[13:16]
    dq_inv = lie.quat_conj(lie.quat_exp_omega(omega, dt))
    d = dt * vel + 0.5 * dt * dt * accel
    return jnp.concatenate([dq_inv, -lie.quat_rotate(dq_inv, d)])


_jac_qt_base = jax.jacfwd(camera_motion_qt, argnums=0)


def transport_by_qt(feat_mu, qt):
    """Transport [..., 3] features [u, v, ρ] by the action qt = [q, t]."""
    z = 1.0 / feat_mu[..., 2]
    p = jnp.stack([feat_mu[..., 0] * z, feat_mu[..., 1] * z, z], -1)
    p = lie.quat_rotate(qt[0:4], p) + qt[4:7]
    return jnp.stack([p[..., 0] / p[..., 2], p[..., 1] / p[..., 2],
                      1.0 / p[..., 2]], -1)


def _rotate_jac_quat(q, p):
    """d(quat_rotate(q, p))/dq, p: [..., 3] → [..., 3, 4].

    The Jacobian of the *implemented* two-cross form
    f = p + 2w(u×p) + 2u×(u×p) (lie.quat_rotate), differentiated
    unconstrained in q = [w, u]:

        ∂f/∂w = 2(u×p)
        ∂f/∂u = 2((uᵀp)I + u pᵀ − 2 p uᵀ − w [p]ₓ)

    Off the unit sphere this differs from the rotation-matrix form, but in
    every chain-rule use here the incoming q-perturbations are tangent to
    the unit sphere (they come from unit-quaternion products), where the
    two agree; using the implemented form keeps W exactly consistent with
    jacfwd of the surrounding quaternion algebra."""
    w, u = q[0], q[1:4]
    uxp = jnp.cross(jnp.broadcast_to(u, p.shape), p)
    col_w = 2.0 * uxp
    eye = jnp.eye(3, dtype=p.dtype)
    utp = jnp.sum(u * p, -1)
    skew_p = jnp.stack([
        jnp.stack([jnp.zeros_like(p[..., 0]), -p[..., 2], p[..., 1]], -1),
        jnp.stack([p[..., 2], jnp.zeros_like(p[..., 0]), -p[..., 0]], -1),
        jnp.stack([-p[..., 1], p[..., 0], jnp.zeros_like(p[..., 0])], -1),
    ], -2)
    block_u = 2.0 * (utp[..., None, None] * eye
                     + u[:, None] * p[..., None, :]        # u pᵀ
                     - 2.0 * p[..., :, None] * u[None, :]  # −2 p uᵀ
                     - w * skew_p)
    return jnp.concatenate([col_w[..., :, None], block_u], -1)


def transport_jacobians(feat_mu, qt):
    """Analytic transport + Jacobians, batched over features.

    Returns (feat' [N,3], Ff [N,3,3] = ∂feat'/∂[u,v,ρ],
             W [N,3,7] = ∂feat'/∂[q,t])."""
    q, t = qt[0:4], qt[4:7]
    R = lie.quat_to_matrix(q)
    z = 1.0 / feat_mu[..., 2]
    h = jnp.stack([feat_mu[..., 0], feat_mu[..., 1], jnp.ones_like(z)], -1)
    p = z[..., None] * h
    p2 = jnp.einsum("ij,...j->...i", R, p) + t

    inv_z2 = 1.0 / p2[..., 2]
    zero = jnp.zeros_like(inv_z2)
    one = jnp.ones_like(inv_z2)
    # projection Jacobian P = ∂[x/z, y/z, 1/z]/∂p', rows scaled by 1/z
    P = inv_z2[..., None, None] * jnp.stack([
        jnp.stack([one, zero, -p2[..., 0] * inv_z2], -1),
        jnp.stack([zero, one, -p2[..., 1] * inv_z2], -1),
        jnp.stack([zero, zero, -inv_z2], -1),
    ], -2)

    # ∂p/∂[u,v,ρ] = [z e1 | z e2 | −z² h]
    dp = jnp.stack([
        jnp.stack([z, zero, -z * z * h[..., 0]], -1),
        jnp.stack([zero, z, -z * z * h[..., 1]], -1),
        jnp.stack([zero, zero, -z * z], -1),
    ], -2)
    PR = jnp.einsum("...ij,jk->...ik", P, R)
    Ff = jnp.einsum("...ij,...jk->...ik", PR, dp)

    dRp_dq = _rotate_jac_quat(q, p)                       # [N, 3, 4]
    W = jnp.concatenate([jnp.einsum("...ij,...jk->...ik", P, dRp_dq), P], -1)

    feat2 = jnp.stack([p2[..., 0] * inv_z2, p2[..., 1] * inv_z2, inv_z2], -1)
    return feat2, Ff, W


_jac_base = jax.jacfwd(convolve_base_state, argnums=0)
# per-feature autodiff blocks — kept as the reference implementation the
# analytic path is unit-tested against
_jac_feat_wrt_base = jax.jacfwd(convolve_feature, argnums=0)
_jac_feat_wrt_self = jax.jacfwd(convolve_feature, argnums=1)


def process_jacobian_blocks_autodiff(base_mu, feat_mu, dt):
    """Per-feature jacfwd blocks (slow path; ground truth for tests)."""
    Fb = _jac_base(base_mu, dt)
    Ffb = jax.vmap(_jac_feat_wrt_base, in_axes=(None, 0, None))(base_mu, feat_mu, dt)
    Ff = jax.vmap(_jac_feat_wrt_self, in_axes=(None, 0, None))(base_mu, feat_mu, dt)
    return Fb, Ffb, Ff


def process_jacobian_blocks(base_mu, feat_mu, dt):
    """Exact Jacobian blocks of the process model.

    Returns:
      Fb:  [22, 22]   d(base')/d(base)        (jacfwd — one small system)
      Ffb: [N, 3, 22] d(feat_i')/d(base)      (analytic, via the action)
      Ff:  [N, 3, 3]  d(feat_i')/d(feat_i)    (analytic)
    """
    Fb = _jac_base(base_mu, dt)
    qt = camera_motion_qt(base_mu, dt)
    Jqt = _jac_qt_base(base_mu, dt)                       # [7, 22]
    _, Ff, W = transport_jacobians(feat_mu, qt)
    Ffb = jnp.einsum("nij,jb->nib", W, Jqt)
    return Fb, Ffb, Ff


def mask_feature_jacobians(Ffb, Ff, active):
    """Inactive slots get identity self-blocks and no base coupling,
    mirroring the reference's treatment of uncoupled states
    (bias rows are identity, TightlyCoupledEKF.cpp:255-257)."""
    a = active[:, None, None]
    eye3 = jnp.eye(3, dtype=Ff.dtype)
    Ff = jnp.where(a, Ff, eye3[None])
    Ffb = jnp.where(a, Ffb, 0.0)
    return Ffb, Ff


def build_dense_F(Fb, Ffb, Ff):
    """Assemble the full [D, D] Jacobian.  D = 22 + 3N.

    F = [[Fb,   0          ],
         [Ffb,  blkdiag(Ff)]]
    """
    n = Ff.shape[0]
    nb = BASE_STATE_SIZE
    dtype = Fb.dtype
    # block assembly by concatenation + 2D masked-broadcast block
    # diagonal, with no index scatter (a gather/scatter-free form; ROADMAP
    # queue 3, item 2 A/Bs it against plain indexing on the GPU)
    from ekf_vio_tpu.core.state import block_diag_dense

    blk = block_diag_dense(Ff)
    top = jnp.concatenate([Fb, jnp.zeros((nb, 3 * n), dtype)], axis=1)
    bot = jnp.concatenate([Ffb.reshape(3 * n, nb), blk], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def propagate_covariance(Sigma, Fb, Ffb, Ff, q_diag):
    """Σ ← F Σ Fᵀ + Q as one dense triple product.

    F is assembled dense ([D, D], D = 22+3N) and the propagation is two
    plain matmuls.  The structured block alternative below does ~8x fewer
    FLOPs but many small einsums, each a separate launch; which one is
    faster on the GPU is not measured yet.  f32 matmul precision is
    mandatory (see propagate_covariance_blocked's docstring).
    """
    return _propagate_covariance_dense_f32(Sigma, Fb, Ffb, Ff, q_diag)


@jax.default_matmul_precision("float32")
def _propagate_covariance_dense_f32(Sigma, Fb, Ffb, Ff, q_diag):
    from ekf_vio_tpu.core.state import diag_embed

    F = build_dense_F(Fb, Ffb, Ff)
    out = F @ Sigma @ F.T + diag_embed(q_diag)
    return 0.5 * (out + out.T)


def propagate_covariance_blocked(Sigma, Fb, Ffb, Ff, q_diag):
    """Σ ← F Σ Fᵀ + Q exploiting the block structure of F.

    Σ = [[Σbb, Σbf], [Σfb, Σff]] with Σbf = Σfbᵀ. Writing
    F = [[Fb, 0], [L, B]] (L = Ffb rows, B = blkdiag(Ff)):

      Σbb' = Fb Σbb Fbᵀ
      Σbf' = Fb (Σbb Lᵀ + Σbf Bᵀ)
      Σff' = L Σbb Lᵀ + L Σbf Bᵀ + (L Σbf Bᵀ)ᵀ ... expanded below

    The block-diagonal products use einsum over [N,3,3] blocks so nothing
    materializes an [3N, 3N] operand with O((3N)²·3N) cost; the remaining
    dense products are small (22-wide).

    All products run at float32 matmul precision: reduced-precision
    passes (bf16, TF32) cannot represent a covariance whose spectrum
    spans 1e-5 (measurement prior) to 1e2 (depth prior); bf16 passes were
    seen to NaN the filter within ~100 steps.
    """
    return _propagate_covariance_f32(Sigma, Fb, Ffb, Ff, q_diag)


@jax.default_matmul_precision("float32")
def _propagate_covariance_f32(Sigma, Fb, Ffb, Ff, q_diag):
    nb = BASE_STATE_SIZE
    n = Ff.shape[0]
    Sbb = Sigma[:nb, :nb]
    Sbf = Sigma[:nb, nb:]
    Sff = Sigma[nb:, nb:]

    L = Ffb.reshape(3 * n, nb)

    # B @ M for block-diagonal B: reshape rows into [N,3,cols] and einsum.
    def blk_left(B, M):  # (blkdiag(B) @ M), M: [3N, c]
        return jnp.einsum("nij,njc->nic", B, M.reshape(n, 3, -1)).reshape(3 * n, -1)

    def blk_right(M, B):  # (M @ blkdiag(B)ᵀ), M: [r, 3N]
        return jnp.einsum("rnj,nij->rni", M.reshape(-1, n, 3), B).reshape(-1, 3 * n)

    Sbb_Lt = Sbb @ L.T                      # [22, 3N]
    Sbf_Bt = blk_right(Sbf, Ff)             # [22, 3N]

    new_Sbb = Fb @ Sbb @ Fb.T
    new_Sbf = Fb @ (Sbb_Lt + Sbf_Bt)

    L_Sbb_Lt = L @ Sbb_Lt                   # [3N, 3N]
    L_Sbf_Bt = L @ Sbf_Bt                   # [3N, 3N]
    B_Sff_Bt = blk_right(blk_left(Ff, Sff), Ff)

    new_Sff = L_Sbb_Lt + L_Sbf_Bt + L_Sbf_Bt.T + B_Sff_Bt

    out = jnp.zeros_like(Sigma)
    out = out.at[:nb, :nb].set(new_Sbb)
    out = out.at[:nb, nb:].set(new_Sbf)
    out = out.at[nb:, :nb].set(new_Sbf.T)
    out = out.at[nb:, nb:].set(new_Sff)
    out = out + jnp.diag(q_diag)
    return 0.5 * (out + out.T)


def process_noise_diag(dt, n_max, active, cfg) -> jnp.ndarray:
    """Diagonal process noise Q(dt) (TightlyCoupledEKF.cpp:123-174).

    pos+quat: q_pos·dt; vel: q_vel·dt; ω and a: q_omega/q_accel·dt (the
    large values that let vision steer the kinematic states); biases:
    q_bias·dt; features: q_feature·dt, zeroed for inactive slots.
    """
    base = jnp.concatenate(
        [
            jnp.full((7,), cfg.q_pos),
            jnp.full((3,), cfg.q_vel),
            jnp.full((3,), cfg.q_omega),
            jnp.full((3,), cfg.q_accel),
            jnp.full((6,), cfg.q_bias),
        ]
    )
    feat = jnp.where(active[:, None], cfg.q_feature, 0.0) * jnp.ones((n_max, 3))
    return jnp.concatenate([base, feat.reshape(-1)]) * dt
