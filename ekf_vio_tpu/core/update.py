"""EKF measurement update — dense, masked, fixed-shape.

The reference's measurement model is a *linear selector* H that picks the
(u, v) components of each successfully tracked feature out of the state
(reference: TightlyCoupledEKF.cpp:634-661), and the update follows the
numerically careful recipe spelled out at TightlyCoupledEKF.cpp:545-552:

    y = z − Hμ
    S = R + HΣHᵀ
    K : solve SᵀKᵀ = (ΣHᵀ)ᵀ        (LDLT in the reference)
    μ ← μ + Ky
    Σ ← (I−KH)Σ(I−KH)ᵀ + KRKᵀ      (Joseph form)
    quaternion renormalized         (TightlyCoupledEKF.cpp:604-609)

Realization here:

* H is never materialized.  Because the selector indices are *static*
  (feature i's (u,v) always live at rows 22+3i, 22+3i+1), HΣ and ΣHᵀ are
  gathers and KH is a scatter of K's columns.
* Variable measurement sets (the reference rebuilds H each frame) become a
  measurement *mask*: unmeasured rows get S̃ = identity / zero gain columns,
  so one fixed-shape Cholesky handles every frame without recompilation.
* The gain solve is a blocked Cholesky (`cho_solve`) — the dense/PSD analog
  of the reference's sparse LDLT — and Σ is symmetrized after the Joseph
  product, realizing the symmetrization the reference's ``fixSigma`` stub
  gestures at (TightlyCoupledEKF.cpp:716-718).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from ekf_vio_tpu.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu.core.state import (
    FilterState,
    diag_of,
    feature_rowcol_indices,
    uv_cols,
    uv_rows,
)


def block_diag_R(R: jnp.ndarray) -> jnp.ndarray:
    """[N, 2, 2] per-feature covariances -> [2N, 2N] block diagonal.

    Built in 2D by masked broadcasts (state.block_diag_dense), with no
    scatter and no 4D eye-broadcast + reshape relayout."""
    from ekf_vio_tpu.core.state import block_diag_dense

    return block_diag_dense(R)


def update_with_feature_positions(
    state: FilterState,
    cfg: VIOConfig,
    measured_uv: jnp.ndarray,  # [N_max, 2] metric positions from the tracker
    meas_cov: jnp.ndarray,     # [N_max, 2, 2] per-feature measurement covariance
    passed: jnp.ndarray,       # [N_max] bool — tracker success (status + border)
    budget: int | None = None,
) -> FilterState:
    """Masked EKF update (analog of TightlyCoupledEKF.cpp:475-628).

    Features with ``passed=False`` contribute nothing (zero gain columns)
    and are deactivated afterwards — the reference only sets a delete flag
    (TightlyCoupledEKF.cpp:525-529) and never reclaims the slot; here the
    slot is freed by the caller via ``drop_features``.

    ``budget`` (static) compacts the measured subset before factorization:
    measured slots are gathered to the front (stable argsort of the mask)
    and only a ``[2·budget, 2·budget]`` system is factorized — the analog
    of the reference building H from passed features only
    (TightlyCoupledEKF.cpp:486-541), recovering the O((2M)³) cost when
    M ≪ N.  Exact (bit-identical gains) whenever the measured count fits
    the budget; measured features beyond it are left uncorrected for the
    frame (they stay active and measured again next frame).  Default:
    no compaction (budget = N_max).

    Runs at float32 matmul precision: reduced-precision passes cannot
    hold the covariance spectrum (1e-5..1e2) and NaN the filter.
    """
    return _update_f32(state, cfg, measured_uv, meas_cov, passed, budget)


@jax.default_matmul_precision("float32")
def _update_f32(state, cfg, measured_uv, meas_cov, passed, budget=None):
    n_full = state.n_max
    d = state.state_dim
    meas_full = passed & state.active                 # [N]

    measured_uv_full = measured_uv
    if budget is not None and budget < n_full:
        n = budget
        # stable argsort of ~meas: measured slots first, in slot order
        order = jnp.argsort(~meas_full, stable=True)
        idx_c = order[:n]                             # [B] slot indices
        uv_idx = (BASE_STATE_SIZE + 3 * idx_c[:, None]
                  + jnp.arange(2)[None, :]).reshape(-1)   # [2B]
        meas = meas_full[idx_c]
        measured_uv = measured_uv[idx_c]
        meas_cov = meas_cov[idx_c]
    else:
        n = n_full
        uv_idx, _ = feature_rowcol_indices(n)
        meas = meas_full

    m = jnp.repeat(meas, 2).astype(state.Sigma.dtype)  # [2N]

    mu = state.mu_flat()
    z = measured_uv.reshape(-1)                       # [2N]
    if budget is not None and budget < n_full:
        # compacted path: indices are data-dependent — gathers required
        y = (z - mu[uv_idx]) * m
        A = state.Sigma[:, uv_idx]                    # [D, 2N]
        S = A[uv_idx, :] + block_diag_R(meas_cov)     # [2N, 2N]
    else:
        # full path: the selector rows are STATIC strides — reshape +
        # contiguous slice instead of gather fusions (uv_rows/uv_cols)
        y = (z - state.feat_mu[:, :2].reshape(-1)) * m
        A = uv_cols(state.Sigma, n)                   # [D, 2N]
        S = uv_rows(A, n) + block_diag_R(meas_cov)    # [2N, 2N]

    # Mask: unmeasured rows/cols collapse to the identity so the Cholesky
    # stays well posed; corresponding gain columns are zeroed through A.
    from ekf_vio_tpu.core.state import diag_embed

    mm = m[:, None] * m[None, :]
    S_true = S * mm           # unregularized masked S — for the Joseph form
    S = S * mm + diag_embed(1.0 - m)
    # Relative spectral floor (see VIOConfig.sigma_jitter_rel): the blocked
    # f32 Cholesky cannot resolve eigenvalues below ~ε·λmax of S anyway —
    # floor them, which statistically just inflates R.
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * jnp.max(diag_of(S) * m)
    S = S + lam * jnp.eye(2 * n, dtype=S.dtype)
    A = A * m[None, :]

    chol = cho_factor(S, lower=True)
    K = cho_solve(chol, A.T).T                        # [D, 2N]
    # NumericalIssue guard (TightlyCoupledEKF.cpp:579): if the factorization
    # still failed, skip the update entirely — the predicted state is always
    # consistent, a half-applied gain is not.
    solve_ok = jnp.isfinite(K).all()
    K = jnp.where(solve_ok, K, 0.0)

    mu = mu + K @ y

    if cfg.joseph_form == "expanded":
        # Joseph form, expanded through the selector structure of H:
        #   (I−KH)Σ(I−KH)ᵀ + KRKᵀ = Σ − K(HΣ) − (ΣHᵀ)Kᵀ + K(HΣHᵀ+R)Kᵀ
        # with HΣ = Aᵀ and HΣHᵀ+R = S_true (the UNregularized masked S —
        # the identity holds for ANY K, so the jittered factorization's
        # gain stays exactly Joseph-consistent).  Identical algebra to the
        # materialized (I−KH) product but rank-2M: ~221 vs ~352 MFLOP at
        # D=406/2N=256, and no [D,D] scatter/eye passes.
        B = K @ A.T                                   # [D, D]
        Sigma = state.Sigma - B - B.T + (K @ S_true) @ K.T
    else:
        # Materialized Joseph product (TightlyCoupledEKF.cpp:586-596):
        # slightly more FLOPs but the subtraction happens in I−KH (norm
        # ~1) BEFORE the quadratic form, so roundoff cannot push Σ
        # indefinite — the conservative choice for accuracy studies.
        KH = jnp.zeros((d, d), state.Sigma.dtype).at[:, uv_idx].set(K)
        I_KH = jnp.eye(d, dtype=state.Sigma.dtype) - KH
        R_full = block_diag_R(meas_cov) * mm
        Sigma = I_KH @ state.Sigma @ I_KH.T + K @ R_full @ K.T
    Sigma = 0.5 * (Sigma + Sigma.T)

    # Quaternion renormalization (TightlyCoupledEKF.cpp:604-609).
    qn = jnp.linalg.norm(mu[3:7])
    mu = mu.at[3:7].divide(qn)

    base_mu = mu[:BASE_STATE_SIZE]
    feat_mu = mu[BASE_STATE_SIZE:].reshape(n_full, 3)

    # Cache tracker results for ALL measured features (Feature.h:43
    # semantics) — including, under compaction, the measured-but-over-
    # budget ones: the measurement is valid regardless of whether the
    # EKF correction was applied, and a stale klt_ref would bias the next
    # frame's LK template by the accumulated inter-frame motion until the
    # search margin kills the track (sustained-overflow starvation).
    if budget is not None and budget < n_full:
        klt_ref = jnp.where(meas_full[:, None], measured_uv_full,
                            state.klt_ref)
    else:
        klt_ref = jnp.where(meas[:, None], measured_uv, state.klt_ref)

    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma, klt_ref=klt_ref)


def innovation_stats(state: FilterState, measured_uv, passed):
    """Mean innovation magnitude over measured features (observability)."""
    n = state.n_max
    meas = passed & state.active
    y = measured_uv - state.feat_mu[:, :2]
    mag = jnp.linalg.norm(y, axis=-1)
    cnt = jnp.maximum(jnp.sum(meas), 1)
    return jnp.sum(jnp.where(meas, mag, 0.0)) / cnt


def innovation_nis_per_feature(state: FilterState, measured_uv, meas_cov,
                               factor: bool = False):
    """[N] per-feature NIS: yᵢᵀ Sᵢ⁻¹ yᵢ with Sᵢ the feature's own 2x2
    innovation covariance block (Σ_uv + Rᵢ), on the PRE-update state.

    Serves two roles: the innovation-side consistency statistic
    (E[NIS] = 2 when calibrated) and the chi-square outlier gate
    (cfg.innovation_gate_chi2).  Block-diagonal form — cross-feature
    innovation correlations are ignored, the standard per-measurement
    practice.  ``factor=True`` reads Σ blocks from a Cholesky-factor
    state (Σ_block = L_uv L_uvᵀ)."""
    n = state.n_max
    y = measured_uv - state.feat_mu[:, :2]                   # [N, 2]
    if factor:
        Luv = uv_rows(state.Sigma, n).reshape(n, 2, -1)      # [N, 2, D]
        Suv = jnp.einsum("nik,njk->nij", Luv, Luv)
    else:
        # the feature's own 2x2 block of Σ, gather-free: uv rows sliced,
        # then the per-feature [2, 3] column group sliced to its [2, 2]
        # the feature's own 2x2 block of Σ, extracted by 2D masked row
        # reductions (any 4D reshape of the tiled [2N, 3N] slice pays a
        # relayout copy, ~23 us/frame):
        #   s_i[3f+j] = Σ_uv[2f+i, 3f+j]
        rows = uv_rows(state.Sigma, n)                       # [2N, D]
        T = rows[:, BASE_STATE_SIZE:]                        # [2N, 3N]
        r_iota = jnp.arange(2 * n)[:, None]
        f_of_c = (jnp.arange(3 * n) // 3)[None, :]
        s0 = jnp.sum(jnp.where(r_iota == 2 * f_of_c, T, 0.0), axis=0)
        s1 = jnp.sum(jnp.where(r_iota == 2 * f_of_c + 1, T, 0.0), axis=0)
        Suv = jnp.stack([s0.reshape(n, 3)[:, :2],
                         s1.reshape(n, 3)[:, :2]], axis=1)   # [N, 2, 2]
    S = Suv + meas_cov
    det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
    det = jnp.maximum(det, 1e-30)
    # closed-form 2x2 inverse quadratic form
    return (S[:, 1, 1] * y[:, 0] ** 2 - 2 * S[:, 0, 1] * y[:, 0] * y[:, 1]
            + S[:, 0, 0] * y[:, 1] ** 2) / det


def innovation_nis(state: FilterState, measured_uv, meas_cov, passed,
                   factor: bool = False):
    """Mean per-feature NIS over measured features (E[NIS] = 2)."""
    nis = innovation_nis_per_feature(state, measured_uv, meas_cov,
                                     factor=factor)
    meas = passed & state.active
    cnt = jnp.maximum(jnp.sum(meas), 1)
    return jnp.sum(jnp.where(meas, nis, 0.0)) / cnt
