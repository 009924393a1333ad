"""Square-root filter: parity with the covariance form + closed-loop
stability with the spectral floor disabled (core/sqrt_filter.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.core import filter as ekf
from ekf_vio_tpu.core import sqrt_filter, update
from ekf_vio_tpu.sim import simulator


def _correlated_state(cfg, steps=4, seed=0):
    """A filter state with real cross-correlations: a few closed-loop
    steps of the dense path on a reference-style scene."""
    key = jax.random.PRNGKey(seed)
    scn = simulator.REFERENCE_SCENARIOS[1]._replace(
        feature_count=cfg.max_features)
    state, _, _ = simulator.run_scenario(key, scn, cfg, steps)
    return state


# Dense comparisons run with the spectral floor off — the floor is a
# covariance-form-only workaround the sqrt path must not need.
CFG = VIOConfig(max_features=12, sigma_jitter_rel=0.0)


class TestParity:
    def test_predict_parity(self):
        state = _correlated_state(CFG)
        dense = ekf.predict(state, CFG, 0.05)
        sq = sqrt_filter.predict_sqrt(state, CFG, 0.05)
        np.testing.assert_allclose(np.asarray(sq.base_mu),
                                   np.asarray(dense.base_mu), atol=1e-6)
        scale = float(jnp.max(jnp.abs(dense.Sigma)))
        np.testing.assert_allclose(np.asarray(sq.Sigma),
                                   np.asarray(dense.Sigma),
                                   atol=2e-4 * scale)

    def test_update_parity_partial_measurements(self):
        state = _correlated_state(CFG)
        n = CFG.max_features
        z = state.feat_mu[:, :2] + 0.003
        meas_cov = jnp.tile(jnp.eye(2) * 1e-5, (n, 1, 1))
        passed = jnp.arange(n) % 3 != 0  # drop a third

        dense = update.update_with_feature_positions(state, CFG, z,
                                                     meas_cov, passed)
        sq = sqrt_filter.update_sqrt(state, CFG, z, meas_cov, passed)

        np.testing.assert_allclose(np.asarray(sq.base_mu),
                                   np.asarray(dense.base_mu), atol=1e-5)
        np.testing.assert_allclose(np.asarray(sq.feat_mu),
                                   np.asarray(dense.feat_mu), atol=1e-5)
        scale = float(jnp.max(jnp.abs(dense.Sigma)))
        np.testing.assert_allclose(np.asarray(sq.Sigma),
                                   np.asarray(dense.Sigma),
                                   atol=2e-4 * scale)

    def test_unmeasured_features_untouched(self):
        state = _correlated_state(CFG)
        n = CFG.max_features
        z = state.feat_mu[:, :2] + 0.01
        meas_cov = jnp.tile(jnp.eye(2) * 1e-5, (n, 1, 1))
        out = sqrt_filter.update_sqrt(state, CFG, z, meas_cov,
                                      jnp.zeros(n, bool))
        # all passed=False: a strict no-op on the mean
        np.testing.assert_allclose(np.asarray(out.base_mu),
                                   np.asarray(state.base_mu), atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.feat_mu),
                                   np.asarray(state.feat_mu), atol=1e-6)
        scale = float(jnp.max(jnp.abs(state.Sigma)))
        np.testing.assert_allclose(np.asarray(out.Sigma),
                                   np.asarray(state.Sigma),
                                   atol=1e-4 * scale)


class TestIsolation:
    def test_inactive_rows_stay_isolated(self):
        cfg = VIOConfig(max_features=8, sigma_jitter_rel=0.0)
        state = _correlated_state(cfg)
        # deactivate half the slots (wipes their Σ rows/cols)
        drop = jnp.arange(8) >= 4
        state = ekf.drop_features(state, drop)
        state = sqrt_filter.predict_sqrt(state, cfg, 0.05)
        z = state.feat_mu[:, :2]
        meas_cov = jnp.tile(jnp.eye(2) * 1e-5, (8, 1, 1))
        state = sqrt_filter.update_sqrt(state, cfg, z, meas_cov,
                                        jnp.ones(8, bool))
        # the stabilization pad must cancel: dropped slots' Σ rows ≈ 0
        from ekf_vio_tpu.core.state import feature_rowcol_indices
        _, uvr = feature_rowcol_indices(8)
        rows = np.asarray(uvr).reshape(8, 3)[4:].reshape(-1)
        leak = np.abs(np.asarray(state.Sigma)[rows]).max()
        assert leak < 1e-5, f"inactive-row leak {leak}"


class TestClosedLoop:
    @pytest.mark.parametrize("scn_idx", [1, 5])
    def test_scenario_converges_no_jitter(self, scn_idx):
        """Closed-loop sim entirely in sqrt form, spectral floor off:
        invariants hold and features converge (the dense form can need
        the floor at ~100 features; sqrt must not)."""
        cfg = VIOConfig(max_features=32, sigma_jitter_rel=0.0,
                        sigma_jitter=0.0, square_root_form=True)
        scn = simulator.REFERENCE_SCENARIOS[scn_idx]
        steps = min(int(round(scn.tf / scn.dt)), 80)
        _, _, telem = simulator.run_scenario(jax.random.PRNGKey(0), scn,
                                             cfg, steps)
        min_diag, asym, pos_err, feat_err = map(np.asarray, telem)
        assert min_diag.min() >= -1e-5
        assert asym.max() < 1e-3
        assert feat_err[-1] < 1e-3
        assert np.isfinite(pos_err).all()

    def test_matches_dense_trajectory(self):
        cfg_d = VIOConfig(max_features=16, sigma_jitter_rel=0.0)
        cfg_s = cfg_d.replace(square_root_form=True)
        scn = simulator.REFERENCE_SCENARIOS[2]
        _, _, td = simulator.run_scenario(jax.random.PRNGKey(3), scn, cfg_d, 40)
        _, _, ts = simulator.run_scenario(jax.random.PRNGKey(3), scn, cfg_s, 40)
        pos_d, pos_s = np.asarray(td[2]), np.asarray(ts[2])
        np.testing.assert_allclose(pos_s, pos_d, atol=2e-4)


class TestFactorNative:
    """Persistent-factor ops (round 4): the engine keeps L across steps —
    predict/update/add/drop/wipe all in factor space, factored once."""

    def test_factor_roundtrip(self):
        state = _correlated_state(CFG)
        rt = sqrt_filter.to_covariance(sqrt_filter.to_factor(state))
        scale = float(jnp.max(jnp.abs(state.Sigma)))
        np.testing.assert_allclose(np.asarray(rt.Sigma),
                                   np.asarray(state.Sigma),
                                   atol=1e-5 * scale)

    def test_factor_predict_update_chain_matches_dense(self):
        """Three predict+update cycles entirely in factor space equal the
        dense chain — no per-step refactorization drift."""
        state = _correlated_state(CFG)
        n = CFG.max_features
        meas_cov = jnp.tile(jnp.eye(2) * 1e-5, (n, 1, 1))

        dense = state
        fact = sqrt_filter.to_factor(state)
        for i in range(3):
            dense = ekf.predict(dense, CFG, 0.05)
            fact = sqrt_filter.predict_sqrt_factor(fact, CFG, 0.05)
            z = dense.feat_mu[:, :2] + 0.002
            passed = jnp.arange(n) % 4 != i % 4
            dense = update.update_with_feature_positions(
                dense, CFG, z, meas_cov, passed)
            fact = sqrt_filter.update_sqrt_factor(
                fact, CFG, z, meas_cov, passed)
        out = sqrt_filter.to_covariance(fact)
        np.testing.assert_allclose(np.asarray(out.base_mu),
                                   np.asarray(dense.base_mu), atol=1e-5)
        np.testing.assert_allclose(np.asarray(out.feat_mu),
                                   np.asarray(dense.feat_mu), atol=1e-5)
        scale = float(jnp.max(jnp.abs(dense.Sigma)))
        np.testing.assert_allclose(np.asarray(out.Sigma),
                                   np.asarray(dense.Sigma),
                                   atol=5e-4 * scale)

    def test_factor_drop_matches_dense(self):
        state = _correlated_state(CFG)
        drop = jnp.arange(CFG.max_features) % 3 == 0
        dense = ekf.drop_features(state, drop)
        fact = sqrt_filter.drop_features_factor(
            sqrt_filter.to_factor(state), drop)
        out = sqrt_filter.to_covariance(fact)
        scale = float(jnp.max(jnp.abs(dense.Sigma)))
        np.testing.assert_allclose(np.asarray(out.Sigma),
                                   np.asarray(dense.Sigma),
                                   atol=1e-5 * scale)
        np.testing.assert_array_equal(np.asarray(out.active),
                                      np.asarray(dense.active))

    def test_factor_add_matches_dense(self):
        """Slot reuse: drop, then re-allocate in factor space — wiped
        rows get the clean prior, survivors keep their correlations."""
        state = _correlated_state(CFG)
        drop = jnp.arange(CFG.max_features) < 4
        dense = ekf.drop_features(state, drop)
        fact = sqrt_filter.drop_features_factor(
            sqrt_filter.to_factor(state), drop)

        uv = jnp.tile(jnp.array([[0.3, -0.2]]), (CFG.max_features, 1))
        valid = jnp.arange(CFG.max_features) < 3
        dense = ekf.add_features(dense, CFG, uv, valid)
        fact = sqrt_filter.add_features_factor(fact, CFG, uv, valid)
        out = sqrt_filter.to_covariance(fact)
        scale = float(jnp.max(jnp.abs(dense.Sigma)))
        np.testing.assert_allclose(np.asarray(out.Sigma),
                                   np.asarray(dense.Sigma),
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(np.asarray(out.feat_mu),
                                   np.asarray(dense.feat_mu), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(out.active),
                                      np.asarray(dense.active))

    def test_wipe_rows_factor_matches_dense_wipe(self):
        state = _correlated_state(CFG)
        L = sqrt_filter.to_factor(state).Sigma
        d = state.state_dim
        wipe = jnp.zeros((d,), bool).at[jnp.array([24, 30, 31])].set(True)
        new_diag = jnp.where(wipe, 0.25, 0.0)
        Lw = sqrt_filter.wipe_rows_factor(L, wipe, new_diag)
        got = np.asarray(Lw @ Lw.T)
        w = np.asarray(wipe)
        ref = np.asarray(state.Sigma).copy()
        ref[w, :] = 0.0
        ref[:, w] = 0.0
        ref[np.where(w)[0], np.where(w)[0]] = 0.25
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, atol=1e-5 * scale)

    def test_engine_sqrt_mode_rendered(self):
        """engine.run_sequence with square_root_form=True: finite,
        tracking, and trajectory close to the dense engine (VERDICT r3
        next-round #7's done-bar)."""
        import jax as _jax

        from ekf_vio_tpu import engine
        from ekf_vio_tpu.sim import rendered

        seq = rendered.generate(num_frames=20, w=160, h=120)
        cam = engine.make_hashable_camera(seq.K, 160, 120)
        imgs = jnp.asarray(seq.frames)
        ts = jnp.asarray(seq.times)
        base = dict(max_features=32, min_new_feature_dist=10.0,
                    fast_threshold=25)
        # floor-off on both: the spectral floor is a covariance-form
        # workaround; with it on, the dense gains differ by the
        # regularization, not by arithmetic error
        cfg_d = VIOConfig(**base, sigma_jitter_rel=0.0)
        cfg_s = VIOConfig(**base, square_root_form=True,
                          sigma_jitter_rel=0.0)
        _, outs_d = engine.run_sequence(imgs, ts, cfg_d, cam)
        _, outs_s = engine.run_sequence(imgs, ts, cfg_s, cam)
        _jax.block_until_ready(outs_s)
        assert np.isfinite(np.asarray(outs_s.base_mu)).all()
        assert np.asarray(outs_s.num_tracked)[3:].min() > 5
        # same scene, same tracker: trajectories agree to mm scale
        dp = np.linalg.norm(np.asarray(outs_s.base_mu)[:, :3]
                            - np.asarray(outs_d.base_mu)[:, :3], axis=-1)
        assert dp.max() < 5e-3, f"sqrt-vs-dense trajectory delta {dp.max()}"
