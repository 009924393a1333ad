"""Camera / frame model: intrinsics maps and frame preprocessing.

Analog of the reference's ``Frame`` + static ``Feature`` helpers:
* pixel↔metric (normalized) coordinate maps (reference: Feature.h:60-66)
* frame downscaling with intrinsics rescale (reference: Frame.cpp:15-41)
* kill-pad border test (reference: Frame.cpp:44-55)

Images are jnp arrays [H, W] float32 in [0, 255]; intrinsics K is the
3x3 pinhole matrix.  Everything is batchable.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CameraModel(NamedTuple):
    """Static per-sequence camera description."""
    K: jnp.ndarray        # [3,3]
    width: int
    height: int

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]


def scale_camera(cam: CameraModel, inverse_scale: int) -> CameraModel:
    """Intrinsics for a 1/inverse_scale downscaled image (Frame.cpp:24-30)."""
    s = 1.0 / inverse_scale
    K = cam.K * jnp.array([[s, s, s], [s, s, s], [1.0, 1.0, 1.0]])
    K = K.at[2, 2].set(1.0)
    return CameraModel(K=K, width=cam.width // inverse_scale,
                       height=cam.height // inverse_scale)


def pixel_to_metric(cam: CameraModel, px: jnp.ndarray) -> jnp.ndarray:
    """[..., 2] pixel -> normalized metric coords (Feature.h:60-62)."""
    return (px - jnp.stack([cam.cx, cam.cy])) / jnp.stack([cam.fx, cam.fy])


def metric_to_pixel(cam: CameraModel, uv: jnp.ndarray) -> jnp.ndarray:
    """[..., 2] normalized metric -> pixel coords (Feature.h:64-66)."""
    return uv * jnp.stack([cam.fx, cam.fy]) + jnp.stack([cam.cx, cam.cy])


def in_kill_box(cam: CameraModel, px: jnp.ndarray, kill_pad: float) -> jnp.ndarray:
    """True where the pixel is at least kill_pad from every border
    (Frame.cpp:44-55; same predicate applied to KLT results,
    KLTTracker.cpp:73)."""
    x, y = px[..., 0], px[..., 1]
    return (
        (x >= kill_pad)
        & (y >= kill_pad)
        & (cam.width - x >= kill_pad)
        & (cam.height - y >= kill_pad)
    )


def downscale_image(img: jnp.ndarray, inverse_scale: int) -> jnp.ndarray:
    """Box-filter downscale by an integer factor (Frame.cpp:18-19 uses
    cv::resize default bilinear; for integer factors an area mean is a
    reshape-and-mean and is what cv::INTER_AREA would do)."""
    if inverse_scale == 1:
        return img
    h, w = img.shape[-2:]
    h2, w2 = h // inverse_scale, w // inverse_scale
    img = img[..., : h2 * inverse_scale, : w2 * inverse_scale]
    img = img.reshape(*img.shape[:-2], h2, inverse_scale, w2, inverse_scale)
    return img.mean(axis=(-3, -1))
