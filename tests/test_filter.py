"""Filter-core unit tests: state bookkeeping + measurement update.

Analog of the reference's H-map and update sanity checks
(reference: test/test_ekf.cpp:51-82) with hard asserts, plus the
slot-allocation semantics that replace list insert/erase.
"""
import jax
import jax.numpy as jnp
import numpy as np

from ekf_vio_tpu.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu.core import filter as ekf
from ekf_vio_tpu.core.state import feature_rowcol_indices

CFG = VIOConfig(max_features=8)


def fresh_state(n_feats=3):
    state = ekf.init_state(CFG)
    uv = jnp.array([[0.1 * (i + 1), -0.1 * (i + 1)] for i in range(CFG.max_features)])
    valid = jnp.arange(CFG.max_features) < n_feats
    return ekf.add_features(state, CFG, uv, valid)


class TestInitState:
    def test_initial_values(self):
        s = ekf.init_state(CFG)
        # base_mu zero except unit quaternion (TightlyCoupledEKF.cpp:25,37)
        assert float(s.base_mu[3]) == 1.0
        np.testing.assert_allclose(np.asarray(s.base_mu[:3]), 0.0)
        diag = np.diag(np.asarray(s.Sigma))
        # pose anchored, kinematics 30, biases 0.5 (cpp:29-54)
        np.testing.assert_allclose(diag[:7], 0.0)
        np.testing.assert_allclose(diag[7:16], 30.0)
        np.testing.assert_allclose(diag[16:22], 0.5)
        assert int(s.num_active()) == 0


class TestAddDropFeatures:
    def test_add_sets_prior(self):
        s = fresh_state(3)
        assert int(s.num_active()) == 3
        diag = np.diag(np.asarray(s.Sigma))
        _, uvr = feature_rowcol_indices(CFG.max_features)
        uvr = np.asarray(uvr).reshape(-1, 3)
        for i in range(3):
            np.testing.assert_allclose(diag[uvr[i][:2]],
                                       CFG.default_point_homogenous_variance)
            np.testing.assert_allclose(diag[uvr[i][2]],
                                       CFG.default_point_depth_variance)
        # unoccupied slots stay zero
        for i in range(3, CFG.max_features):
            np.testing.assert_allclose(diag[uvr[i]], 0.0)
        # inverse-depth initialization: rho = 1/default_depth (Feature.cpp:18)
        np.testing.assert_allclose(np.asarray(s.feat_mu[:3, 2]),
                                   1.0 / CFG.default_point_depth)

    def test_add_no_initial_cross_correlation(self):
        """New features start uncorrelated (TightlyCoupledEKF.cpp:66-67)."""
        s = fresh_state(2)
        Sig = np.asarray(s.Sigma)
        _, uvr = feature_rowcol_indices(CFG.max_features)
        uvr = np.asarray(uvr).reshape(-1, 3)
        np.testing.assert_allclose(Sig[uvr[0]][:, uvr[1]], 0.0)
        np.testing.assert_allclose(Sig[:BASE_STATE_SIZE][:, uvr[0]], 0.0)

    def test_add_respects_capacity(self):
        s = ekf.init_state(CFG)
        uv = jnp.zeros((20, 2))
        s = ekf.add_features(s, CFG, uv, jnp.ones(20, bool))
        assert int(s.num_active()) == CFG.max_features

    def test_drop_frees_slot_and_wipes_sigma(self):
        s = fresh_state(3)
        # introduce correlations first
        s = ekf.predict(s, CFG, 0.05)
        drop = jnp.zeros((CFG.max_features,), bool).at[1].set(True)
        s2 = ekf.drop_features(s, drop)
        assert int(s2.num_active()) == 2
        _, uvr = feature_rowcol_indices(CFG.max_features)
        uvr1 = np.asarray(uvr).reshape(-1, 3)[1]
        np.testing.assert_allclose(np.asarray(s2.Sigma)[uvr1, :], 0.0)
        np.testing.assert_allclose(np.asarray(s2.Sigma)[:, uvr1], 0.0)

    def test_slot_reuse_resets_rows(self):
        """Re-allocating a freed slot must not inherit stale correlations
        (addNewFeatures Σ-insertion semantics, TightlyCoupledEKF.cpp:58-94)."""
        s = fresh_state(3)
        s = ekf.predict(s, CFG, 0.05)
        drop = jnp.zeros((CFG.max_features,), bool).at[0].set(True)
        s = ekf.drop_features(s, drop)
        uv = jnp.tile(jnp.array([[0.7, 0.7]]), (CFG.max_features, 1))
        s = ekf.add_features(s, CFG, uv, jnp.arange(CFG.max_features) < 1)
        assert int(s.num_active()) == 3
        assert bool(s.active[0])
        np.testing.assert_allclose(np.asarray(s.feat_mu[0, :2]), [0.7, 0.7])
        _, uvr = feature_rowcol_indices(CFG.max_features)
        uvr0 = np.asarray(uvr).reshape(-1, 3)[0]
        Sig = np.asarray(s.Sigma)
        # off-diagonal rows wiped, diagonal reset to the prior
        off = Sig[uvr0, :].copy()
        off[np.arange(3), uvr0] = 0.0
        np.testing.assert_allclose(off, 0.0)
        np.testing.assert_allclose(Sig[uvr0, uvr0],
                                   [CFG.default_point_homogenous_variance,
                                    CFG.default_point_homogenous_variance,
                                    CFG.default_point_depth_variance])


def run_update(s, z, passed, var=1e-5):
    cov = jnp.tile(jnp.eye(2) * var, (CFG.max_features, 1, 1))
    return ekf.update_with_feature_positions(s, CFG, z, cov, passed)


class TestUpdate:
    def test_exact_measurement_reduces_uncertainty(self):
        s = fresh_state(3)
        s = ekf.predict(s, CFG, 0.05)
        pre_diag = np.diag(np.asarray(s.Sigma)).copy()
        z = s.feat_mu[:, :2]  # measure exactly the predicted positions
        passed = s.active
        s2 = run_update(s, z, passed)
        post_diag = np.diag(np.asarray(s2.Sigma))
        _, uvr = feature_rowcol_indices(CFG.max_features)
        uv_of = np.asarray(uvr).reshape(-1, 3)[:3, :2].reshape(-1)
        assert np.all(post_diag[uv_of] < pre_diag[uv_of] + 1e-9)
        # mean unchanged when innovation is zero
        np.testing.assert_allclose(np.asarray(s2.feat_mu[:3]),
                                   np.asarray(s.feat_mu[:3]), atol=1e-6)
        np.testing.assert_allclose(np.asarray(s2.base_mu),
                                   np.asarray(s.base_mu), atol=1e-6)

    def test_innovation_moves_feature_towards_measurement(self):
        s = fresh_state(1)
        z = s.feat_mu[:, :2] + jnp.array([[0.01, -0.01]])
        s2 = run_update(s, z, s.active)
        moved = np.asarray(s2.feat_mu[0, :2] - s.feat_mu[0, :2])
        # prior uv var 1e-5 vs meas var 1e-5 -> gain 0.5
        np.testing.assert_allclose(moved, [0.005, -0.005], atol=1e-4)

    def test_failed_features_contribute_nothing(self):
        """Partial measurement: the un-passed feature's state and covariance
        are untouched (H excludes it — TightlyCoupledEKF.cpp:634-661)."""
        s = fresh_state(3)
        s = ekf.predict(s, CFG, 0.05)
        z = s.feat_mu[:, :2] + 0.01
        passed = s.active.at[1].set(False)
        s2 = run_update(s, z, passed)
        # feature 1 mean may shift only through correlations with the base
        # state introduced by the update of others; with a fresh filter and
        # zero base-feature correlation in the uv block... verify the strict
        # property on a fresh (uncorrelated) state instead:
        s0 = fresh_state(3)
        z0 = s0.feat_mu[:, :2] + 0.01
        s3 = run_update(s0, z0, s0.active.at[1].set(False))
        np.testing.assert_allclose(np.asarray(s3.feat_mu[1]),
                                   np.asarray(s0.feat_mu[1]), atol=1e-7)
        _, uvr = feature_rowcol_indices(CFG.max_features)
        uvr1 = np.asarray(uvr).reshape(-1, 3)[1]
        np.testing.assert_allclose(
            np.asarray(s3.Sigma)[uvr1, uvr1],
            np.asarray(s0.Sigma)[uvr1, uvr1], atol=1e-7)
        assert bool(s2.active[1])  # update itself does not deactivate

    def test_quaternion_normalized(self):
        s = fresh_state(3)
        s = ekf.predict(s, CFG, 0.05)
        z = s.feat_mu[:, :2] + 0.05
        s2 = run_update(s, z, s.active)
        np.testing.assert_allclose(
            float(jnp.linalg.norm(s2.base_mu[3:7])), 1.0, atol=1e-6)

    def test_sigma_stays_symmetric_psd_diag(self):
        s = fresh_state(3)
        for _ in range(5):
            s = ekf.predict(s, CFG, 0.05)
            z = s.feat_mu[:, :2] + 0.001
            s = run_update(s, z, s.active)
        min_diag, asym = ekf.check_sigma(s)
        assert float(min_diag) >= -1e-6
        assert float(asym) < 1e-3  # SYM_EPS (TightlyCoupledEKF.cpp:700)

    def test_klt_ref_cached_for_passed(self):
        """Measured positions are cached for tracker seeding
        (Feature.h:43, TightlyCoupledEKF.cpp:511)."""
        s = fresh_state(2)
        z = s.feat_mu[:, :2] + 0.02
        passed = s.active.at[1].set(False)
        s2 = run_update(s, z, passed)
        np.testing.assert_allclose(np.asarray(s2.klt_ref[0]), np.asarray(z[0]))
        np.testing.assert_allclose(np.asarray(s2.klt_ref[1]),
                                   np.asarray(s.klt_ref[1]))

    def test_update_jits_and_matches_eager(self):
        s = fresh_state(3)
        z = s.feat_mu[:, :2] + 0.01
        cov = jnp.tile(jnp.eye(2) * 1e-5, (CFG.max_features, 1, 1))
        jitted = jax.jit(
            lambda st, zz: ekf.update_with_feature_positions(st, CFG, zz, cov, st.active)
        )
        a = jitted(s, z)
        b = ekf.update_with_feature_positions(s, CFG, z, cov, s.active)
        np.testing.assert_allclose(np.asarray(a.Sigma), np.asarray(b.Sigma),
                                   rtol=1e-5, atol=1e-6)


class TestCompactedUpdate:
    """Measured-subset compaction (budget): gather measured slots to a
    static budget before factorization — the analog of the reference
    building H only from passed features (TightlyCoupledEKF.cpp:486-541)."""

    def _mixed_state(self, n_feats=6):
        s = fresh_state(n_feats)
        s = ekf.predict(s, CFG, 0.05)  # introduce cross-correlations
        return s

    def test_compacted_matches_full_when_it_fits(self):
        s = self._mixed_state(6)
        z = s.feat_mu[:, :2] + 0.01
        cov = jnp.tile(jnp.eye(2) * 1e-5, (CFG.max_features, 1, 1))
        passed = s.active.at[1].set(False).at[4].set(False)  # 4 measured
        full = ekf.update_with_feature_positions(s, CFG, z, cov, passed)
        comp = ekf.update_with_feature_positions(s, CFG, z, cov, passed,
                                                 budget=4)
        np.testing.assert_allclose(np.asarray(comp.base_mu),
                                   np.asarray(full.base_mu),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(comp.feat_mu),
                                   np.asarray(full.feat_mu),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(comp.Sigma),
                                   np.asarray(full.Sigma),
                                   rtol=1e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(comp.klt_ref),
                                   np.asarray(full.klt_ref), atol=1e-7)

    def test_compacted_matches_full_budget_larger_than_measured(self):
        s = self._mixed_state(5)
        z = s.feat_mu[:, :2] + 0.005
        cov = jnp.tile(jnp.eye(2) * 1e-5, (CFG.max_features, 1, 1))
        passed = s.active.at[0].set(False)  # 4 measured, budget 6
        full = ekf.update_with_feature_positions(s, CFG, z, cov, passed)
        comp = ekf.update_with_feature_positions(s, CFG, z, cov, passed,
                                                 budget=6)
        np.testing.assert_allclose(np.asarray(comp.Sigma),
                                   np.asarray(full.Sigma),
                                   rtol=1e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(comp.mu_flat()),
                                   np.asarray(full.mu_flat()),
                                   rtol=1e-5, atol=1e-6)

    def test_overflow_features_left_uncorrected(self):
        """More measured features than budget: the update applies the
        budgeted subset only (slot order), overflow features keep their
        predicted mean but stay active."""
        s = self._mixed_state(6)
        z = s.feat_mu[:, :2] + 0.01
        cov = jnp.tile(jnp.eye(2) * 1e-5, (CFG.max_features, 1, 1))
        passed = s.active  # 6 measured, budget 3
        comp = ekf.update_with_feature_positions(s, CFG, z, cov, passed,
                                                 budget=3)
        # equivalent full-path update measuring only the first 3 slots
        sub = passed & (jnp.arange(CFG.max_features) < 3)
        ref = ekf.update_with_feature_positions(s, CFG, z, cov, sub)
        np.testing.assert_allclose(np.asarray(comp.mu_flat()),
                                   np.asarray(ref.mu_flat()),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(comp.Sigma),
                                   np.asarray(ref.Sigma),
                                   rtol=1e-3, atol=5e-4)
        assert bool(comp.active.all() == s.active.all())

    def test_compacted_jits(self):
        s = self._mixed_state(4)
        z = s.feat_mu[:, :2] + 0.002
        cov = jnp.tile(jnp.eye(2) * 1e-5, (CFG.max_features, 1, 1))
        jitted = jax.jit(lambda st, zz: ekf.update_with_feature_positions(
            st, CFG, zz, cov, st.active, budget=4))
        a = jitted(s, z)
        b = ekf.update_with_feature_positions(s, CFG, z, cov, s.active,
                                              budget=4)
        np.testing.assert_allclose(np.asarray(a.Sigma), np.asarray(b.Sigma),
                                   rtol=1e-3, atol=1e-3)


class TestJosephForms:
    """The expanded and materialized Joseph forms are algebraically
    identical for any gain (core/update.py); both stay symmetric/PSD."""

    def test_forms_agree(self):
        import dataclasses as dc

        cfg_p = dc.replace(CFG, joseph_form="product")
        s = fresh_state(4)
        s = ekf.predict(s, CFG, 0.05)
        z = s.feat_mu[:, :2] + 0.01
        cov = jnp.tile(jnp.eye(2) * 1e-5, (CFG.max_features, 1, 1))
        a = ekf.update_with_feature_positions(s, CFG, z, cov, s.active)
        b = ekf.update_with_feature_positions(s, cfg_p, z, cov, s.active)
        np.testing.assert_allclose(np.asarray(a.Sigma), np.asarray(b.Sigma),
                                   rtol=1e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(a.mu_flat()),
                                   np.asarray(b.mu_flat()),
                                   rtol=1e-5, atol=1e-7)
        min_diag, asym = ekf.check_sigma(b)
        assert float(min_diag) >= -1e-6
        assert float(asym) < 1e-3


class TestIndexAlgebraHelpers:
    """Gather/scatter-free index helpers (core/state.py) vs their naive
    advanced-indexing definitions — the replacements must be exact."""

    def test_uv_rows_cols_diag(self):
        import numpy as np

        from ekf_vio_tpu.core import state as sm

        rng = np.random.RandomState(0)
        n = 6
        d = 22 + 3 * n
        M = jnp.asarray(rng.randn(d, d).astype(np.float32))
        uv, uvr = sm.feature_rowcol_indices(n)
        np.testing.assert_array_equal(np.asarray(sm.uv_rows(M, n)),
                                      np.asarray(M[uv]))
        np.testing.assert_array_equal(np.asarray(sm.uv_cols(M, n)),
                                      np.asarray(M[:, uv]))
        np.testing.assert_allclose(np.asarray(sm.diag_of(M)),
                                   np.asarray(jnp.diag(M)), rtol=1e-6)
        v = jnp.asarray(rng.randn(d).astype(np.float32))
        np.testing.assert_array_equal(np.asarray(sm.diag_embed(v)),
                                      np.asarray(jnp.diag(v)))

    def test_block_diag_dense(self):
        import numpy as np
        import scipy.linalg

        from ekf_vio_tpu.core.state import block_diag_dense

        rng = np.random.RandomState(1)
        for k in (2, 3):
            B = rng.randn(5, k, k).astype(np.float32)
            got = np.asarray(block_diag_dense(jnp.asarray(B)))
            ref = scipy.linalg.block_diag(*B)
            np.testing.assert_array_equal(got, ref)
