"""Parity tests for the fused LK tracker kernel (frontend/pallas_lk.py)
— the GPU tracking path — against the XLA reference tracker
(frontend/klt.py), in Pallas interpret mode on the CPU.

Covers the semantics the reference pins in KLTTracker.cpp:61-95:
initial-flow seeding, multi-level handoff, min-eigen gating, border/
search-margin track loss, err/min_eig outputs, invalid rows, and the
custom_vmap batched path.  The compiled kernel is checked on the card by
tests/test_gpu_hardware.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.frontend import klt, pallas_lk, pyramid


def _scene(h=128, w=192, n=32, shift=(1.6, -2.4), shear=0.0, seed=3):
    """Textured image pair: cur = prev translated by `shift` (dy, dx)
    and optionally sheared; n feature positions on texture."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    if shear:
        mat = np.array([[1.0, shear], [0.0, 1.0]])
        img2 = ndi.affine_transform(img, mat, order=3, mode="nearest")
        img2 = ndi.shift(img2, shift, order=3, mode="nearest")
    else:
        img2 = ndi.shift(img, shift, order=3, mode="nearest")
    q = rng.uniform(25, min(h, w) - 25, (n, 2)).astype(np.float32)
    return (jnp.asarray(img.astype(np.float32)),
            jnp.asarray(img2.astype(np.float32)), jnp.asarray(q))


def _run_both(prev, cur, q, init, valid, cfg, levels=2):
    prev_pyr = pyramid.build_pyramid(prev, levels)
    cur_pyr = pyramid.build_pyramid(cur, levels)
    ref = klt.track_xla(prev_pyr, cur_pyr, q, init, valid, cfg)
    got = pallas_lk.track(prev_pyr, cur_pyr, q, init, valid, cfg,
                          interpret=True)
    return ref, got


def _assert_parity(ref, got, pos_tol=0.05, err_tol=0.75, eig_rtol=0.02):
    """status must agree exactly and positions to <pos_tol px (these two
    feed the filter, engine.py:166-169); err/min_eig are diagnostics —
    err differs by bf16 patch rounding (intensities 0-255 round to ~0.5),
    so its tolerance is absolute-intensity scale."""
    g, ok, err, eig = got
    ok = np.asarray(ok)
    ref_ok = np.asarray(ref.status)
    np.testing.assert_array_equal(ok, ref_ok)
    both = ok & ref_ok
    if both.any():
        d = np.abs(np.asarray(g) - np.asarray(ref.points))[both]
        assert d.max() < pos_tol, f"max position delta {d.max():.4f} px"
        de = np.abs(np.asarray(err) - np.asarray(ref.error))[both]
        bound = err_tol + 0.04 * np.asarray(ref.error)[both]
        assert (de < bound).all(), f"max err delta {de.max():.4f}"
        ev = np.asarray(eig)[both]
        rv = np.asarray(ref.min_eig)[both]
        np.testing.assert_allclose(ev, rv, rtol=eig_rtol, atol=1e-3)


class TestPallasLKParity:
    def test_translation_parity(self):
        prev, cur, q = _scene()
        cfg = VIOConfig(max_features=32)
        valid = jnp.ones(32, bool)
        ref, got = _run_both(prev, cur, q, q, valid, cfg)
        assert np.asarray(ref.status).sum() >= 28  # scene is trackable
        _assert_parity(ref, got)

    @pytest.mark.slow
    def test_wide_level_parity(self):
        """640-wide level 0 (the reference's native resolution): parity
        with the XLA tracker over a 3-level pyramid."""
        prev, cur, q = _scene(h=480, w=640, n=32, shift=(1.2, -2.0))
        cfg = VIOConfig(max_features=32)
        valid = jnp.ones(32, bool)
        ref, got = _run_both(prev, cur, q, q, valid, cfg, levels=3)
        assert np.asarray(ref.status).sum() >= 28
        _assert_parity(ref, got)

    def test_shear_parity(self):
        prev, cur, q = _scene(shear=0.04, shift=(0.7, 1.1))
        cfg = VIOConfig(max_features=32)
        valid = jnp.ones(32, bool)
        ref, got = _run_both(prev, cur, q, q, valid, cfg)
        assert np.asarray(ref.status).sum() >= 20
        _assert_parity(ref, got)

    def test_seeded_initial_flow(self):
        """OPTFLOW_USE_INITIAL_FLOW semantics: seeding at the true
        displaced position must converge identically to the XLA path
        (KLTTracker.cpp:53-64)."""
        prev, cur, q = _scene(shift=(3.0, -3.5))
        cfg = VIOConfig(max_features=32)
        valid = jnp.ones(32, bool)
        init = q + jnp.asarray([-3.5, 3.0])  # (x, y) seed near the truth
        ref, got = _run_both(prev, cur, q, init, valid, cfg)
        assert np.asarray(ref.status).sum() >= 28
        _assert_parity(ref, got)

    def test_border_and_margin_features(self):
        """Features near the image border and near the per-level search
        margin: status agreement is the contract (who gets killed by the
        in-bounds / within-margin gates)."""
        prev, cur, q = _scene(shift=(0.0, -4.0), n=32)
        # overwrite some rows with border-hugging / margin-straining pts
        qn = np.asarray(q).copy()
        qn[0] = (2.0, 2.0)           # at the border -> killed
        qn[1] = (189.0, 125.0)       # at the far border
        qn[2] = (3.0, 64.0)
        qn[3] = (96.0, 2.5)
        cfg = VIOConfig(max_features=32)
        valid = jnp.ones(32, bool)
        ref, got = _run_both(prev, cur, jnp.asarray(qn), jnp.asarray(qn),
                             valid, cfg)
        ref_ok = np.asarray(ref.status)
        assert not ref_ok[:2].any()  # border features must die in both
        _assert_parity(ref, got)

    def test_track_loss_beyond_margin(self):
        """A seed offset past the +-5 px/level pyramid budget at level 0
        only: run single-level so the coarse level cannot absorb it —
        the feature must fail in both paths, not wander."""
        prev, cur, q = _scene(shift=(0.0, 0.0))
        cfg = VIOConfig(max_features=32)
        valid = jnp.ones(32, bool)
        init = q + jnp.asarray([14.0, 0.0])
        ref, got = _run_both(prev, cur, q, init, valid, cfg, levels=0)
        ref_ok = np.asarray(ref.status)
        got_ok = np.asarray(got[1])
        np.testing.assert_array_equal(got_ok, ref_ok)
        # the +-5 px margin is a hard budget: anything reported tracked
        # must sit within it — a feature cannot claim the true position
        # 14 px away (it either locks onto local texture inside the
        # margin, identically in both paths, or is killed)
        for pts, okm in ((np.asarray(ref.points), ref_ok),
                         (np.asarray(got[0]), got_ok)):
            if okm.any():
                d = np.abs(pts[okm] - np.asarray(init)[okm])
                assert d.max() <= 5.0 + 1e-3
        assert ref_ok.sum() < 32  # the offset does kill a real fraction

    def test_min_eigen_gating_flat_region(self):
        """Features on a flat (gradient-free) region fail the min-eigen
        gate in both paths (KLT_MIN_EIGEN, Params.h:36)."""
        prev, cur, q = _scene()
        flat = np.full((128, 192), 80.0, np.float32)
        fq = np.asarray(q).copy()
        cfg = VIOConfig(max_features=32)
        valid = jnp.ones(32, bool)
        ref, got = _run_both(jnp.asarray(flat), jnp.asarray(flat),
                             jnp.asarray(fq), jnp.asarray(fq), valid, cfg)
        assert not np.asarray(ref.status).any()
        assert not np.asarray(got[1]).any()

    def test_invalid_rows_and_nonfinite_inputs(self):
        """valid=False rows stay untracked and never poison the batch;
        NaN positions in invalid rows are tolerated (the engine stores
        NaN in dead slots)."""
        prev, cur, q = _scene()
        qn = np.asarray(q).copy()
        qn[5] = np.nan
        qn[9] = np.nan
        valid = np.ones(32, bool)
        valid[5] = valid[9] = False
        valid[11] = False  # finite but masked
        cfg = VIOConfig(max_features=32)
        ref, got = _run_both(prev, cur, jnp.asarray(qn), jnp.asarray(qn),
                             jnp.asarray(valid), cfg)
        got_ok = np.asarray(got[1])
        assert not got_ok[[5, 9, 11]].any()
        assert np.isfinite(np.asarray(got[0])[np.asarray(valid)]).all()
        _assert_parity(ref, got)

    def test_vmapped_batch_matches_per_lane(self):
        """The custom_vmap rule must produce exactly what B independent
        single-lane calls produce (parallel/batched_engine.py relies on
        this)."""
        cfg = VIOConfig(max_features=32)
        lanes = [_scene(seed=s, shift=(0.9 * s, -1.1)) for s in (1, 2, 3)]
        prev_b = jnp.stack([l[0] for l in lanes])
        cur_b = jnp.stack([l[1] for l in lanes])
        q_b = jnp.stack([l[2] for l in lanes])
        valid = jnp.ones((3, 32), bool)

        def one(prev, cur, q, v):
            pp = pyramid.build_pyramid(prev, 2)
            cp = pyramid.build_pyramid(cur, 2)
            return pallas_lk.track(pp, cp, q, q, v, cfg, interpret=True)

        got = jax.vmap(one)(prev_b, cur_b, q_b, valid)
        for i in range(3):
            ref = one(prev_b[i], cur_b[i], q_b[i], valid[i])
            np.testing.assert_allclose(np.asarray(got[0][i]),
                                       np.asarray(ref[0]), atol=1e-4)
            np.testing.assert_array_equal(np.asarray(got[1][i]),
                                          np.asarray(ref[1]))
            np.testing.assert_allclose(np.asarray(got[2][i]),
                                       np.asarray(ref[2]), atol=1e-4)
            np.testing.assert_allclose(np.asarray(got[3][i]),
                                       np.asarray(ref[3]), atol=1e-4)


class TestSupportedGate:
    def test_window_size_gate(self):
        """The flattened window must fit one 1024-lane block: windows up
        to 32x32 are covered, larger ones are rejected, not mis-shaped."""
        assert pallas_lk.supported(128, win=21)
        assert pallas_lk.supported(128, win=15)
        assert pallas_lk.supported(128, win=31)
        assert not pallas_lk.supported(128, win=33)

    def test_block_and_vmem_gates(self):
        """One program per feature: any feature count; the image size is
        not a parameter at all."""
        assert pallas_lk.supported(100, win=21)
        assert pallas_lk.supported(512, win=21)
        assert pallas_lk.supported(128, win=21)
        assert not pallas_lk.supported(0, win=21)

    def test_dispatch_respects_window_size(self):
        """klt.selected_backend never picks the kernel for a window it
        does not cover, and never off the GPU."""
        from unittest import mock

        cfg = VIOConfig(max_features=128, klt_window_size=33)
        with mock.patch.object(jax, "default_backend", lambda: "gpu"):
            assert klt.selected_backend((120, 160), 128, cfg) == "xla"
        assert klt.selected_backend(
            (120, 160), 128, cfg.replace(klt_window_size=21)) == "xla"


@pytest.mark.parametrize("win", [15, 17])
def test_other_window_sizes_match_xla(win):
    """The kernel is not tied to the reference's 21x21 window."""
    prev, cur, q = _scene()
    cfg = VIOConfig(max_features=32, klt_window_size=win)
    ref, got = _run_both(prev, cur, q, q, jnp.ones(32, bool), cfg)
    assert np.asarray(ref.status).sum() >= 24
    _assert_parity(ref, got)
