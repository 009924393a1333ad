"""FAST-9 + NMS (frontend/fast.py) against a plain NumPy reference.

The reference decides the segment test by the longest circular run of
brighter (or darker) ring pixels — a different formulation from the
engine's 32 static arc windows — and applies the engine's documented
conventions: edge-replicated ring reads, the score max over qualifying
9-arcs of sum(|ring - c| - t), 3x3 NMS keeping ties, a zeroed 3-px
margin."""
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_vio_tpu.frontend import fast


def _max_circular_run(flags):
    """[16, H, W] bool -> [H, W] length of the longest circular run."""
    doubled = np.concatenate([flags, flags], 0)
    run = np.zeros(flags.shape[1:], np.int32)
    best = np.zeros_like(run)
    for f in doubled:
        run = np.where(f, run + 1, 0)
        best = np.maximum(best, run)
    return np.minimum(best, 16)


def fast9_reference(img, t):
    img = np.asarray(img, np.float64)
    h, w = img.shape
    p = np.pad(img, 3, mode="edge")
    ring = np.stack([p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
                     for dy, dx in fast._CIRCLE])
    d = ring - img[None]
    bright, dark = d > t, d < -t
    corner = (_max_circular_run(bright) >= 9) | (_max_circular_run(dark) >= 9)
    score = np.zeros((h, w))
    ex = np.abs(d) - t
    for s in range(16):
        arc = [(s + k) % 16 for k in range(9)]
        ok = bright[arc].all(0) | dark[arc].all(0)
        score = np.maximum(score, np.where(ok, ex[arc].sum(0), 0.0))
    score = np.where(corner, score, 0.0)
    sp = np.pad(score, 1, constant_values=-np.inf)
    pooled = np.max([sp[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
    out = np.where((score >= pooled) & (score > 0), score, 0.0)
    out[:3], out[-3:], out[:, :3], out[:, -3:] = 0, 0, 0, 0
    return out


def _blob_scene(shape):
    rng = np.random.RandomState(0)
    img = np.zeros(shape, np.float32)
    for _ in range(25):
        y, x = rng.randint(5, shape[0] - 10), rng.randint(5, shape[1] - 10)
        img[y: y + 5, x: x + 5] = rng.uniform(100, 250)
    return img


def _rect_scene(shape):
    img = np.zeros(shape, np.float32)
    img[20:30, 40:60] = 100.0
    return img


@pytest.mark.parametrize("scene,shape,threshold", [
    (_blob_scene, (120, 160), 50.0),
    (_blob_scene, (100, 130), 50.0),
    (_blob_scene, (64, 64), 50.0),
    (_rect_scene, (64, 128), 30.0),
    (_rect_scene, (64, 128), 150.0),
])
def test_detect_matches_numpy_reference(scene, shape, threshold):
    img = scene(shape)
    got = np.asarray(fast.detect(jnp.asarray(img), threshold))
    ref = fast9_reference(img, threshold)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_threshold_behavior():
    """A low threshold finds the rectangle's corners, one above its
    contrast finds nothing."""
    img = jnp.asarray(_rect_scene((64, 128)))
    assert (np.asarray(fast.detect(img, 30.0)) > 0).sum() >= 4
    assert (np.asarray(fast.detect(img, 150.0)) > 0).sum() == 0
