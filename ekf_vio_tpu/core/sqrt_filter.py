"""Square-root (Cholesky-factor) predict/update — the conditioning-first
variant the reference's ``fixSigma`` stub gestures at
(reference: TightlyCoupledEKF.cpp:716-718; SURVEY.md §7 hard-part 3).

Both steps run entirely in factor space, eliminating every
cancellation-prone operation of the covariance form:

* predict:  Σ' = FΣFᵀ + Q   becomes   L' = tria([F L | √Q])
* update:   the QR array algorithm — one orthogonal triangularization of

      pre = [[√R,  H L],          postᵀ = qr(preᵀ)  ⇒  post = [[S^c, 0 ],
             [ 0,   L ]]                                       [ G,  L']]

  with S^c S^cᵀ = HΣHᵀ+R, G = ΣHᵀS^{-cᵀ}, and L'L'ᵀ the *Joseph-exact*
  posterior — no Cholesky of S, no explicit gain matrix squaring, no
  (I−KH)Σ(I−KH)ᵀ subtraction, and PSD by construction.  The relative
  spectral floor (VIOConfig.sigma_jitter_rel) is NOT needed here for
  stability, but it is honored as gain damping to match the covariance
  path's semantics (applied to the gain factorization only; the
  posterior uses the true R — see update_sqrt_factor).

State representation (round 4, persistent factor): with
``VIOConfig.square_root_form`` the engine keeps the LOWER CHOLESKY FACTOR
``L`` in ``FilterState.Sigma`` ACROSS steps — factored once at
initialization (``to_factor``) and never re-squared in the loop:

* predict:   L' = tria([F L | √Q])                      (one QR)
* update:    the QR array algorithm below                (one QR)
* drop:      zero the dropped slots' ROWS of L — exact: Σ row/col r
             vanish and every other entry is untouched (the stale
             below-diagonal column entries L[j,r] encode legitimate
             correlations among the survivors and stay)
* add/boot:  Σ' = PΣPᵀ + diag(prior) on the wiped rows is
             L' = tria([P L | √prior·e_r ...]) — one QR re-
             triangularization (``wipe_rows_factor``)

Rows of exactly-zero variance (the anchored pose gauge, freed slots) are
zero rows of L throughout; QR propagates them as zero columns of the
pre-array with no stabilization needed.  ``to_covariance`` squares the
factor for output/checkpoint consumers.

The legacy dense-boundary entry points (predict_sqrt / update_sqrt) are
kept as to_factor → factor op → to_covariance wrappers: they remain the
ground truth the parity tests pin, and what the facade uses when a caller
hands over a dense Σ.

Orthogonal transforms cannot amplify error, so the factor-space steps are
backward-stable where the covariance form loses ~half the working
precision to squaring — the reason this variant holds 503-slot updates in
f32 with zero spectral floor while the floored-off covariance form
diverges (benchmarks/sqrt_validation.py checks this on the GPU).

Two findings behind the current form:
(1) the one-QR array form realizes the posterior of the λ-INFLATED R
    whenever the spectral floor is applied to the gain, i.e. Σ' + KλKᵀ —
    fixed below by a second Joseph-exact triangularization with the true
    R (lockstep per-step |ΔΣ| vs float64 on the CPU: 3e-2 → 4e-7, now
    matching the covariance path);
(2) the closed-loop scenario metric is dominated by the monocular
    filter's own gauge drift: on the CPU the float64 dense reference
    lands at 0.049 after 300 steps, float32 gives dense 0.0645 / sqrt
    0.0632, so form-vs-form accuracy is compared against the float64
    reference on one platform, never across platforms.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ekf_vio_tpu.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu.core import dynamics
from ekf_vio_tpu.core.state import (
    FilterState,
    diag_embed as state_mod_diag_embed,
    feature_rowcol_indices,
)
from ekf_vio_tpu.core.update import block_diag_R


def _stabilized_chol(Sigma):
    """Lower Cholesky factor of Σ with exactly-zero diagonal entries
    (PSD ⇒ whole row/col is zero) temporarily pinned to 1.

    Returns (L, pad) where pad is the indicator of pinned entries; callers
    subtract diag(pad) back off the squared result.  The pinned rows stay
    e_k through F (identity rows for uncoupled states), √Q (zero), and the
    update (zero gain columns), so the round trip is exact to fp error in
    rows that are wiped again on slot reuse anyway.
    """
    from ekf_vio_tpu.core.state import diag_embed, diag_of

    d = diag_of(Sigma)
    pad = (d == 0.0).astype(Sigma.dtype)
    return jnp.linalg.cholesky(Sigma + diag_embed(pad)), pad


def _tria(pre_T: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular factor of pre_Tᵀ·pre_T via one QR (pre_T: [M, D]),
    with the diagonal sign-normalized nonnegative."""
    R = jnp.linalg.qr(pre_T, mode="r")
    s = jnp.sign(jnp.diagonal(R))
    s = jnp.where(s == 0, 1.0, s)
    return (R * s[:, None]).T


def to_factor(state: FilterState) -> FilterState:
    """Dense-Σ state → factor state (Sigma field holds lower L).

    Exactly-zero-variance rows (PSD ⇒ whole row/col zero) become zero
    rows of L."""
    L, pad = _stabilized_chol(state.Sigma)
    return state.replace(Sigma=L * (1.0 - pad)[:, None])


def to_covariance(state: FilterState) -> FilterState:
    """Factor state → dense-Σ state."""
    L = state.Sigma
    Sigma = L @ L.T
    return state.replace(Sigma=0.5 * (Sigma + Sigma.T))


def sigma_diag_factor(L: jnp.ndarray) -> jnp.ndarray:
    """diag(LLᵀ) without squaring: row norms²."""
    return jnp.sum(L * L, axis=1)


def wipe_rows_factor(L: jnp.ndarray, wipe: jnp.ndarray,
                     new_diag: jnp.ndarray) -> jnp.ndarray:
    """Factor-space analog of zeroing Σ rows/cols ``wipe`` and setting
    their diagonal to ``new_diag``: L' = tria([P L | √new_diag e_r ...]).

    wipe: [D] bool/float row selector; new_diag: [D] variances (read only
    at wiped rows).  One [2D, D] QR.
    """
    w = wipe.astype(L.dtype)
    L1 = L * (1.0 - w)[:, None]
    # where-select, not multiply: new_diag may carry NaN at NON-wiped rows
    # (e.g. sig_tri computed over all slots incl. NaN-mean dead ones) and
    # NaN*0 = NaN would poison the whole factor through the QR
    from ekf_vio_tpu.core.state import diag_embed

    add = diag_embed(jnp.where(w > 0.0,
                               jnp.sqrt(jnp.maximum(new_diag, 0.0)), 0.0))
    return _tria(jnp.concatenate([L1.T, add], axis=0))


@jax.default_matmul_precision("float32")
def predict_sqrt_factor(state: FilterState, cfg: VIOConfig, dt) -> FilterState:
    """Factor-native process step: L' = tria([F L | √Q])."""
    dt = jnp.asarray(dt, state.base_mu.dtype)

    Fb, Ffb, Ff = dynamics.process_jacobian_blocks(state.base_mu,
                                                   state.feat_mu, dt)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)

    new_feat = dynamics.convolve_features(state.base_mu, state.feat_mu, dt)
    feat_mu = jnp.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(state.base_mu, dt)

    q_diag = dynamics.process_noise_diag(dt, state.n_max, state.active,
                                         cfg).astype(state.Sigma.dtype)

    F = dynamics.build_dense_F(Fb, Ffb, Ff)
    L = state.Sigma
    from ekf_vio_tpu.core.state import diag_embed

    A = jnp.concatenate([(F @ L).T, diag_embed(jnp.sqrt(q_diag))], axis=0)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=_tria(A),
                         t=state.t + dt)


@jax.default_matmul_precision("float32")
def propagate_imu_factor(state: FilterState, cfg: VIOConfig, batch,
                         gravity_w, lin_base=None):
    """Factor-native compound IMU propagation (the sqrt twin of
    imu.propagate_imu_batch_with_motion): one QR of

        [ (F L)ᵀ ; (T·chol(Q29))ᵀ ; diag(√q_feat) ]

    where T = [[I₂₂, 0], [0, Wm]] maps the 29-dim compound noise onto the
    state.  Returns (state', qt)."""
    from ekf_vio_tpu.config import BASE_STATE_SIZE as nb
    from ekf_vio_tpu.core import imu as imu_mod

    dtype = state.Sigma.dtype
    base_mu, qt, qt_lin, J, Q29, total_dt = imu_mod.compound_interval(
        state.base_mu, cfg, batch, gravity_w, dtype, lin_base=lin_base)

    Fb = J[:nb, :nb]
    new_feat = jax.vmap(imu_mod._compound_transport, in_axes=(0, None))(
        state.feat_mu, qt)
    _, Ff, W = dynamics.transport_jacobians(state.feat_mu, qt_lin)
    Ffb = jnp.einsum("nij,jb->nib", W, J[nb:, :nb])
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    W = jnp.where(state.active[:, None, None], W, 0.0)

    q_feat = jnp.where(state.active[:, None], cfg.q_feature, 0.0) * jnp.ones(
        (state.n_max, 3), dtype) * total_dt
    q_diag = jnp.concatenate([jnp.zeros(nb, dtype), q_feat.reshape(-1)])

    # noise factor: Q_total = T Q29 Tᵀ with T = [[I, 0], [0, Wm]]
    jit29 = 1e-12 * jnp.maximum(jnp.max(jnp.diagonal(Q29)), 1e-30)
    C29 = jnp.linalg.cholesky(Q29 + jit29 * jnp.eye(29, dtype=dtype))
    Wm = W.reshape(3 * state.n_max, 7)
    TC = jnp.concatenate(
        [C29[:nb, :], Wm @ C29[nb:, :]], axis=0)          # [D, 29]

    F = dynamics.build_dense_F(Fb, Ffb, Ff)
    L = state.Sigma
    A = jnp.concatenate(
        [(F @ L).T, TC.T, state_mod_diag_embed(jnp.sqrt(q_diag))], axis=0)
    Lp = _tria(A)

    feat_mu = jnp.where(state.active[:, None], new_feat, state.feat_mu)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Lp,
                         t=state.t + total_dt), qt


@jax.default_matmul_precision("float32")
def update_sqrt_factor(
    state: FilterState,
    cfg: VIOConfig,
    measured_uv: jnp.ndarray,  # [N_max, 2]
    meas_cov: jnp.ndarray,     # [N_max, 2, 2]
    passed: jnp.ndarray,       # [N_max] bool
) -> FilterState:
    """Factor-native masked QR-array measurement update (state.Sigma holds
    L in AND out)."""
    n = state.n_max
    d = state.state_dim
    uv_idx, _ = feature_rowcol_indices(n)

    meas = passed & state.active
    m = jnp.repeat(meas, 2).astype(state.Sigma.dtype)  # [2N]

    mu = state.mu_flat()
    y = (measured_uv.reshape(-1) - mu[uv_idx]) * m

    L = state.Sigma
    HL = L[uv_idx, :] * m[:, None]                      # [2N, D]

    # Relative spectral floor, same semantics as the covariance-form
    # update (update.py:115-119): λ = jitter + rel · max(diag S) added to
    # R.  The factor form does not need it for STABILITY (orthogonal
    # transforms keep L' PSD by construction) — but the floor is also a
    # measured accuracy regularizer: it statistically inflates R, damping
    # the gain against linearization/model mismatch.  Running the sqrt
    # form without it was the r4 "accuracy inversion" (sqrt 0.063 vs
    # covariance+floor 0.020 final pos err at 128 slots): a tuning
    # difference, not an arithmetic defect — see
    # benchmarks/sqrt_validation.py.
    r_diag = jnp.diagonal(meas_cov, axis1=-2, axis2=-1).reshape(-1)  # [2N]
    s_diag = (jnp.sum(HL * HL, axis=1) + r_diag) * m
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * jnp.max(s_diag)

    Rc_blocks = jnp.linalg.cholesky(
        meas_cov + (lam + 1e-30) * jnp.eye(2, dtype=meas_cov.dtype))
    Rc = block_diag_R(Rc_blocks)
    mm = m[:, None] * m[None, :]
    Rc = Rc * mm + state_mod_diag_embed(1.0 - m)

    two_n = 2 * n
    pre_T = jnp.concatenate(
        [
            jnp.concatenate([Rc.T, jnp.zeros((two_n, d), L.dtype)], axis=1),
            jnp.concatenate([HL.T, L.T], axis=1),
        ],
        axis=0,
    )
    U = jnp.linalg.qr(pre_T, mode="r")
    post = U.T

    Sc = post[:two_n, :two_n]          # chol(HΣHᵀ + R + λ)
    G = post[two_n:, :two_n]           # ΣHᵀ Sc⁻ᵀ

    # Gain from the λ-damped factorization: K = ΣHᵀ(S+λ)⁻¹ = G Sc⁻¹ —
    # identical damping to the covariance path's jittered solve.
    e = solve_triangular(Sc, y, lower=True)
    K = solve_triangular(Sc.T, G.T, lower=False).T      # [D, 2N]
    ok = jnp.isfinite(e).all() & jnp.isfinite(K).all()
    e = jnp.where(ok, e, 0.0)
    K = jnp.where(ok, K, 0.0)

    mu = mu + G @ e                    # = K y

    # Posterior: Joseph-exact triangularization for THIS gain with the
    # TRUE (un-inflated) R — L' = tria([(I−KH)L | K·cholR]).  PSD by
    # construction for any K.  The one-QR array form's L' block instead
    # realizes the posterior of the λ-INFLATED R, i.e. Σ' + KλKᵀ; that
    # extra inflation every step is exactly the covariance-path/sqrt-path
    # divergence the r4 A/B traced (per-step |ΔΣ| 3e-2 vs 5e-5 at k=10;
    # final pos err 3x) — the covariance path dampens only the gain
    # (update.py uses the unregularized S_true in its Joseph form).
    Rc_true = block_diag_R(jnp.linalg.cholesky(
        meas_cov + 1e-30 * jnp.eye(2, dtype=meas_cov.dtype))) * mm
    pre2 = jnp.concatenate([(L - K @ HL).T, (K @ Rc_true).T], axis=0)
    Lp = _tria(pre2)
    Lp = jnp.where(ok, Lp, state.Sigma)

    qn = jnp.linalg.norm(mu[3:7])
    mu = mu.at[3:7].divide(qn)

    base_mu = mu[:BASE_STATE_SIZE]
    feat_mu = mu[BASE_STATE_SIZE:].reshape(n, 3)
    klt_ref = jnp.where(meas[:, None], measured_uv, state.klt_ref)

    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Lp,
                         klt_ref=klt_ref)


def drop_features_factor(state: FilterState, drop: jnp.ndarray) -> FilterState:
    """Factor-space slot free: zero the dropped slots' ROWS of L.

    Exact without any QR: with row r of L zero, Σ = LLᵀ has zero row and
    column r while every other entry keeps its value (the below-diagonal
    column entries L[j, r] contribute only to surviving correlations)."""
    from ekf_vio_tpu.core import state as state_mod

    n = state.n_max
    drop = drop & state.active
    drop3 = jnp.repeat(drop, 3)
    # uvr covers exactly indices >= BASE_STATE_SIZE: concat, not scatter
    keep = jnp.concatenate([
        jnp.ones((BASE_STATE_SIZE,), state.Sigma.dtype),
        1.0 - drop3.astype(state.Sigma.dtype)])
    L = state.Sigma * keep[:, None]
    return state.replace(active=state.active & ~drop, Sigma=L)


def add_features_factor(state: FilterState, cfg: VIOConfig,
                        new_uv: jnp.ndarray, valid: jnp.ndarray,
                        depths: jnp.ndarray | None = None,
                        depth_vars: jnp.ndarray | None = None) -> FilterState:
    """Factor-space add_features: same slot assignment and mean/bookkeeping
    semantics as state.add_features, with the Σ wipe + diagonal prior
    realized as ONE QR re-triangularization (wipe_rows_factor)."""
    from ekf_vio_tpu.core import state as state_mod

    n = state.n_max
    take, src = state_mod.plan_insertion(state.active, valid)

    if depths is None:
        rho = jnp.full((n, 1), 1.0 / cfg.default_point_depth,
                       state.feat_mu.dtype)
    else:
        rho = (1.0 / jnp.clip(depths[src], 1e-3, 1e3))[:, None]
    new_mu = jnp.concatenate([new_uv[src], rho], axis=-1)

    feat_mu = jnp.where(take[:, None], new_mu, state.feat_mu)
    klt_ref = jnp.where(take[:, None], new_uv[src], state.klt_ref)
    active = state.active | take

    take3 = jnp.repeat(take, 3)
    wipe = jnp.concatenate([
        jnp.zeros((BASE_STATE_SIZE,), state.Sigma.dtype),
        take3.astype(state.Sigma.dtype)])
    if depth_vars is None:
        dvar = jnp.full((n,), cfg.default_point_depth_variance,
                        state.Sigma.dtype)
    else:
        dvar = jnp.clip(depth_vars[src], 1e-8,
                        cfg.default_point_depth_variance)
    prior3 = jnp.stack(
        [jnp.full((n,), cfg.default_point_homogenous_variance,
                  state.Sigma.dtype),
         jnp.full((n,), cfg.default_point_homogenous_variance,
                  state.Sigma.dtype),
         dvar], axis=-1).reshape(-1)
    new_diag = jnp.concatenate([
        jnp.zeros((BASE_STATE_SIZE,), state.Sigma.dtype), prior3])
    L = wipe_rows_factor(state.Sigma, wipe, new_diag)

    age = jnp.where(take, 0, state.age)
    return state.replace(feat_mu=feat_mu, active=active, klt_ref=klt_ref,
                         Sigma=L, age=age)


@jax.default_matmul_precision("float32")
def predict_sqrt(state: FilterState, cfg: VIOConfig, dt) -> FilterState:
    """Dense-boundary square-root process step (legacy wrapper):
    factor on entry, one QR, square on exit."""
    return to_covariance(predict_sqrt_factor(to_factor(state), cfg, dt))


def update_sqrt(
    state: FilterState,
    cfg: VIOConfig,
    measured_uv: jnp.ndarray,  # [N_max, 2]
    meas_cov: jnp.ndarray,     # [N_max, 2, 2]
    passed: jnp.ndarray,       # [N_max] bool
) -> FilterState:
    """Dense-boundary masked square-root measurement update (legacy
    wrapper around the factor-native QR array update).

    Semantics match update.update_with_feature_positions (selector H on
    the (u,v) slots, Joseph-consistent posterior, failed features
    contribute nothing); only the arithmetic differs.
    """
    return to_covariance(
        update_sqrt_factor(to_factor(state), cfg, measured_uv, meas_cov,
                           passed))
