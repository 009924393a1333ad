"""The tracker's plain XLA path on known-shift scenes, and the rule that
picks between it and the fused GPU kernel (klt.selected_backend)."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.frontend import klt, pyramid


def _scene(h=128, w=192, n=32):
    """Smooth texture and a copy shifted by (dy, dx) = (0.8, -1.4)."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(3)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    img2 = ndi.shift(img, (0.8, -1.4), order=3, mode="nearest")
    q = rng.uniform(30, min(h, w) - 30, (n, 2)).astype(np.float32)
    return (jnp.asarray(img.astype(np.float32)),
            jnp.asarray(img2.astype(np.float32)), jnp.asarray(q))


class TestXlaTracker:
    def test_known_shift(self):
        prev, cur, q = _scene()
        cfg = VIOConfig(max_features=q.shape[0])
        res = klt.track_xla(pyramid.build_pyramid(prev, 2),
                            pyramid.build_pyramid(cur, 2), q, q,
                            jnp.ones(q.shape[0], bool), cfg)
        ok = np.asarray(res.status)
        assert ok.sum() >= 0.8 * q.shape[0]
        d = np.asarray(res.points)[ok] - np.asarray(q)[ok]
        np.testing.assert_allclose(d, np.tile([-1.4, 0.8], (ok.sum(), 1)),
                                   atol=0.15)

    def test_invalid_rows_stay_put(self):
        prev, cur, q = _scene()
        cfg = VIOConfig(max_features=q.shape[0])
        res = klt.track_xla(pyramid.build_pyramid(prev, 2),
                            pyramid.build_pyramid(cur, 2), q, q,
                            jnp.zeros(q.shape[0], bool), cfg)
        np.testing.assert_allclose(np.asarray(res.points), np.asarray(q),
                                   atol=1e-6)
        assert not np.asarray(res.status).any()


def _on_gpu():
    return mock.patch.object(jax, "default_backend", lambda: "gpu")


@pytest.mark.parametrize("shape,n,win,on_gpu,expected", [
    ((120, 160), 128, 21, False, "xla"),
    ((240, 320), 512, 21, False, "xla"),
    ((120, 160), 128, 21, True, "pallas_lk"),
    ((240, 320), 512, 21, True, "pallas_lk"),
    ((480, 640), 100, 21, True, "pallas_lk"),  # any feature count
    ((120, 160), 128, 33, True, "xla"),        # window exceeds one block
    ((120, 160), 0, 21, True, "xla"),          # nothing to track
])
def test_selected_backend(shape, n, win, on_gpu, expected):
    cfg = VIOConfig(max_features=max(n, 1), klt_window_size=win)
    if on_gpu:
        with _on_gpu():
            assert klt.selected_backend(shape, n, cfg) == expected
    else:
        assert klt.selected_backend(shape, n, cfg) == expected


def test_gpu_selection_lowers_plain_path_on_cpu():
    """With the GPU selected, work lowered for the CPU (a host-side run
    inside a GPU process) still takes the plain path: the choice is made
    again at lowering time."""
    prev, cur, q = _scene(n=16)
    cfg = VIOConfig(max_features=16)
    pp, cp = pyramid.build_pyramid(prev, 2), pyramid.build_pyramid(cur, 2)
    v = jnp.ones(16, bool)
    ref = klt.track_xla(pp, cp, q, q, v, cfg)
    with _on_gpu():
        assert klt.selected_backend(prev.shape, 16, cfg) == "pallas_lk"
        got = jax.jit(lambda *a: klt.track(*a, cfg))(pp, cp, q, q, v)
    np.testing.assert_array_equal(np.asarray(got.status),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(np.asarray(got.points),
                               np.asarray(ref.points), atol=1e-5)
