"""TightlyCoupledEKF — functional facade over the core pieces.

The reference bundles everything into one mutable class
(reference: TightlyCoupledEKF.h:16-72).  The equivalent here is a
set of pure functions over a ``FilterState`` pytree, so the whole filter
composes with jit / vmap / scan / shard_map.  This module re-exports the
state ops and provides ``predict`` (process) to mirror the reference API:

    reference                     ->  here
    --------------------------------------------------------------
    TightlyCoupledEKF()           ->  init_state(cfg)
    addNewFeatures(...)           ->  add_features(state, cfg, uv, valid)
    process(dt)                   ->  predict(state, cfg, dt)
    updateWithFeaturePositions()  ->  update_with_feature_positions(...)
    previousFeaturePositionVector ->  state.klt_ref
    checkSigma()                  ->  check_sigma(state)
"""
from __future__ import annotations

import jax.numpy as jnp

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.core import dynamics
from ekf_vio_tpu.core.state import (  # noqa: F401  (re-exports)
    FilterState,
    add_features,
    check_sigma,
    drop_features,
    init_state,
)
from ekf_vio_tpu.core.update import innovation_stats  # noqa: F401
from ekf_vio_tpu.core.update import (
    update_with_feature_positions as _update_covariance_form,
)


def update_with_feature_positions(state, cfg, measured_uv, meas_cov, passed,
                                  budget=None):
    """EKF update, dispatching on VIOConfig.square_root_form: the dense
    covariance-form update (core/update.py) or the QR square-root array
    update (core/sqrt_filter.py) — identical semantics, different
    conditioning/cost tradeoff.  ``budget`` (static) compacts the measured
    subset before factorization (dense path; see core/update.py)."""
    if cfg.square_root_form:
        # budget >= n_max is the dense path's no-op; only an actual
        # compaction request is unimplemented for the QR-array update
        if budget is not None and budget < state.n_max:
            raise ValueError(
                "measured-subset compaction (budget) is implemented for "
                "the covariance-form update only; the sqrt QR-array "
                "update runs the full masked system")
        from ekf_vio_tpu.core import sqrt_filter

        return sqrt_filter.update_sqrt(state, cfg, measured_uv, meas_cov,
                                       passed)
    return _update_covariance_form(state, cfg, measured_uv, meas_cov, passed,
                                   budget)


def predict(state: FilterState, cfg: VIOConfig, dt) -> FilterState:
    """Process step (analog of TightlyCoupledEKF::process, cpp:96-121).

    1. exact Jacobian blocks (replacing O(9N) central differences,
       TightlyCoupledEKF.cpp:176-325),
    2. mean transport for features then base (order matters — features are
       transported with the *pre-update* base state, cpp:102-107),
    3. Σ ← FΣFᵀ + Q via structured blocked matmuls (cpp:113-117; the
       sparse prune is unnecessary for a dense representation).

    With VIOConfig.square_root_form the covariance propagation runs as an
    orthogonal triangularization instead (core/sqrt_filter.py).
    """
    if cfg.square_root_form:
        from ekf_vio_tpu.core import sqrt_filter

        return sqrt_filter.predict_sqrt(state, cfg, dt)
    dt = jnp.asarray(dt, state.base_mu.dtype)

    Fb, Ffb, Ff = dynamics.process_jacobian_blocks(state.base_mu, state.feat_mu, dt)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)

    new_feat = dynamics.convolve_features(state.base_mu, state.feat_mu, dt)
    feat_mu = jnp.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(state.base_mu, dt)

    q_diag = dynamics.process_noise_diag(dt, state.n_max, state.active, cfg).astype(
        state.Sigma.dtype
    )
    Sigma = dynamics.propagate_covariance(state.Sigma, Fb, Ffb, Ff, q_diag)

    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma, t=state.t + dt)
