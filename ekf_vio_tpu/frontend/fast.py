"""FAST-9/16 corner detection — whole-image, branch-free, elementwise.

The reference calls cv::FAST with non-max suppression on the full frame
(reference: EKFVIO.cpp:242) with threshold FAST_THRESHOLD (Params.h:24)
after an optional Gaussian blur (EKFVIO.cpp:228-230).

Design: the 16 Bresenham-circle neighbors are 16 shifted views of the
(padded) image, the segment test ("≥9 contiguous circle pixels all
brighter than center+t or all darker than center−t") becomes 32
vectorized AND-reductions over static arc windows, and NMS is a 3x3
max-pool — dense elementwise work that XLA fuses into a few passes.  No
per-pixel branching, no dynamic shapes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (the classic FAST-16 ring, clockwise from
# 12 o'clock) as (dy, dx).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9


def _shifted_ring(img: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] stack of circle-neighbor intensities (edge-padded)."""
    p = jnp.pad(img, 3, mode="edge")
    h, w = img.shape
    return jnp.stack([p[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]
                      for dy, dx in _CIRCLE])


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Corner response map: 0 for non-corners, else an arc-SAD score.

    A pixel is a corner if some contiguous arc of 9 circle pixels is all
    brighter than c+t or all darker than c−t.  The score is the maximum
    over qualifying arcs of Σ(|ring − c| − t) — the SAD-style response
    used for NMS ordering (same family as cv::FAST's score; exact score
    definitions differ between implementations, positions do not).
    """
    img = img.astype(jnp.float32)
    ring = _shifted_ring(img)                       # [16, H, W]
    diff = ring - img[None]
    bright = diff > threshold                       # [16, H, W]
    dark = diff < -threshold
    excess = jnp.abs(diff) - threshold

    # wraparound arcs: duplicate the first ARC_LEN-1 entries
    bright2 = jnp.concatenate([bright, bright[: ARC_LEN - 1]], axis=0)
    dark2 = jnp.concatenate([dark, dark[: ARC_LEN - 1]], axis=0)
    excess2 = jnp.concatenate([excess, excess[: ARC_LEN - 1]], axis=0)

    score = jnp.zeros_like(img)
    for s in range(16):
        b_ok = jnp.all(bright2[s : s + ARC_LEN], axis=0)
        d_ok = jnp.all(dark2[s : s + ARC_LEN], axis=0)
        arc_sad = jnp.sum(excess2[s : s + ARC_LEN], axis=0)
        score = jnp.maximum(score, jnp.where(b_ok | d_ok, arc_sad, 0.0))
    return score


def non_max_suppress(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only 3x3-neighborhood maxima (cv::FAST nonmaxSuppression)."""
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((score >= pooled) & (score > 0.0), score, 0.0)


def detect(img: jnp.ndarray, threshold: float, nms: bool = True) -> jnp.ndarray:
    """Full-frame FAST-9: returns the (optionally NMS'd) score map.

    Pixels within 3 of the border are zeroed (the ring would read padding;
    cv::FAST likewise skips a 3px margin)."""
    score = fast_score_map(img, threshold)
    if nms:
        score = non_max_suppress(score)
    h, w = img.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    margin = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(margin, score, 0.0)


def gaussian_blur(img: jnp.ndarray, sigma: float, ksize: int = 5) -> jnp.ndarray:
    """Separable Gaussian blur (pre-detection smoothing, EKFVIO.cpp:228-230)."""
    if sigma <= 0.0:
        return img
    half = ksize // 2
    x = jnp.arange(-half, half + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / jnp.sum(k)
    p = jnp.pad(img, ((half, half), (0, 0)), mode="edge")
    img = sum(p[i : i + img.shape[0], :] * k[i] for i in range(ksize))
    p = jnp.pad(img, ((0, 0), (half, half)), mode="edge")
    return sum(p[:, i : i + img.shape[1]] * k[i] for i in range(ksize))
