"""Compiled-kernel tests that need a GPU; they skip without one.

The regular suite runs the tracker kernel in interpret mode on the CPU
(tests/test_pallas_lk.py); these exercise what the GPU compiles.  Run on
a machine with a card, one process:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu_hardware.py \
        -m gpu -q -p no:xdist

Whether a card is present is decided inside the fixture, never while the
module is imported, so every worker collects the same tests.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a "
                    "machine with a card)")
    return jax.devices()[0]


def test_device_is_gpu(gpu):
    assert gpu.platform == "gpu"


def test_selector_picks_the_kernel(gpu):
    from ekf_vio_tpu.config import VIOConfig
    from ekf_vio_tpu.frontend import klt

    cfg = VIOConfig(max_features=128)
    assert klt.selected_backend((120, 160), 128, cfg) == "pallas_lk"
    assert klt.selected_backend((240, 320), 512, cfg) == "pallas_lk"


@pytest.mark.parametrize("h,w,n", [(120, 160, 128), (240, 320, 512),
                                   (480, 640, 128)])
def test_compiled_kernel_matches_xla(gpu, h, w, n):
    """The compiled kernel against the plain tracker at float32 matmul
    precision, multi-level, with seeded flow."""
    import jax
    import jax.numpy as jnp
    import scipy.ndimage as ndi

    from ekf_vio_tpu.config import VIOConfig
    from ekf_vio_tpu.frontend import klt, pallas_lk, pyramid

    rng = np.random.RandomState(3)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    img2 = ndi.shift(img, (1.3, -2.1), order=3, mode="nearest")
    q = jnp.asarray(np.stack([rng.uniform(22, w - 22, n),
                              rng.uniform(22, h - 22, n)], -1), jnp.float32)
    valid = jnp.ones((n,), bool)
    cfg = VIOConfig(max_features=n)
    pp = pyramid.build_pyramid(jnp.asarray(img, jnp.float32), 3)
    cp = pyramid.build_pyramid(jnp.asarray(img2, jnp.float32), 3)
    init = q + jnp.asarray([-2.1, 1.3])
    g, ok, _, _ = jax.jit(lambda *a: pallas_lk.track(*a, cfg))(
        pp, cp, q, init, valid)
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(lambda *a: klt.track_xla(*a, cfg))(
            pp, cp, q, init, valid)
    ok, ref_ok = np.asarray(ok), np.asarray(ref.status)
    assert ref_ok.sum() > 0.85 * n
    assert (ok == ref_ok).mean() >= 0.99
    both = ok & ref_ok
    np.testing.assert_allclose(np.asarray(g)[both],
                               np.asarray(ref.points)[both], atol=0.02)


def test_full_step_compiled_finite(gpu):
    import jax
    import jax.numpy as jnp

    from ekf_vio_tpu import engine
    from ekf_vio_tpu.config import VIOConfig

    cfg = VIOConfig(max_features=64)
    w, h = 160, 120
    cam = engine.make_hashable_camera(
        [[115.0, 0, w / 2], [0, 115.0, h / 2], [0, 0, 1]], w, h)
    rng = np.random.RandomState(0)
    base = (rng.uniform(0, 255, (h, w + 8)) > 128).astype(np.float32) * 200.0
    e = engine.initialize(jnp.asarray(base[:, :w]), 0.0, cfg, cam)
    e, out = jax.jit(engine.step, static_argnums=(3, 4))(
        e, jnp.asarray(base[:, 2:w + 2]), jnp.float32(0.05), cfg, cam)
    assert np.isfinite(np.asarray(out.base_mu)).all()
    assert int(out.num_tracked) > 5
