"""Image pyramid construction (front-end shared by KLT and detection).

The reference delegates pyramids to OpenCV inside calcOpticalFlowPyrLK
(reference: KLTTracker.cpp:61-64) and carries a half-built custom Pyramid
struct (KLTTracker.h:29-83) used only by its smoke test.  Here the pyramid
is an explicit tuple of arrays so levels have static shapes under jit, and
the 5-tap binomial smoothing + 2x decimation matches cv::pyrDown's kernel.

All ops are separable convolutions — elementwise work that XLA fuses.
"""
from __future__ import annotations

import jax.numpy as jnp

# cv::pyrDown smoothing kernel [1, 4, 6, 4, 1] / 16 (separable binomial).
_K5 = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _sep_filter5(img: jnp.ndarray) -> jnp.ndarray:
    """Separable 5-tap binomial blur with edge replication, [H, W]."""
    p = jnp.pad(img, ((2, 2), (0, 0)), mode="edge")
    img = sum(p[i : i + img.shape[0], :] * _K5[i] for i in range(5))
    p = jnp.pad(img, ((0, 0), (2, 2)), mode="edge")
    img = sum(p[:, i : i + img.shape[1]] * _K5[i] for i in range(5))
    return img


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """Blur + take even rows/cols (cv::pyrDown semantics).

    The decimation is phrased as reshape-to-phases + unit slice instead
    of ``[::2, ::2]`` (bit-identical output), a form chosen on a machine
    where strided slices were slow; on the GPU it is not yet A/B'd
    against the plain slice (ROADMAP queue 3, item 2)."""
    f = _sep_filter5(img)
    h, w = f.shape
    if h % 2:  # [::2] keeps ceil(h/2) samples incl. the last row/col
        f = jnp.concatenate([f, f[-1:]], 0)
    if w % 2:
        f = jnp.concatenate([f, f[:, -1:]], 1)
    hp, wp = f.shape
    fe = f.reshape(hp // 2, 2, wp)[:, 0]
    return fe.reshape(hp // 2, wp // 2, 2)[:, :, 0]


def build_pyramid(img: jnp.ndarray, levels: int) -> tuple:
    """Returns (level0, level1, ..., level_{levels}) — levels+1 images,
    level L downscaled by 2^L.  Matches calcOpticalFlowPyrLK's maxLevel
    convention (maxLevel=3 -> 4 images)."""
    out = [img.astype(jnp.float32)]
    for _ in range(levels):
        out.append(pyr_down(out[-1]))
    return tuple(out)


def top_tracked_level(pyr, win: int) -> int:
    """Index of the coarsest level the tracker uses.  Levels smaller than
    the tracking window are skipped (cv::buildOpticalFlowPyramid clamps
    maxLevel the same way): a 21x21 window on a 16x16 level only aliases
    border content."""
    top = 0
    for lvl, level in enumerate(pyr):
        if min(level.shape[-2:]) >= win:
            top = lvl
    return top


def gradients(img: jnp.ndarray):
    """Scharr 3x3 derivative images (the kernel OpenCV's LK tracker uses
    for its spatial gradients: smooth [3,10,3]/32 cross-derive [-1,0,1])."""
    smooth = jnp.array([3.0, 10.0, 3.0]) / 32.0
    deriv = jnp.array([-1.0, 0.0, 1.0])

    def sep(im, ky, kx):
        p = jnp.pad(im, ((1, 1), (0, 0)), mode="edge")
        im = sum(p[i : i + im.shape[0], :] * ky[i] for i in range(3))
        p = jnp.pad(im, ((0, 0), (1, 1)), mode="edge")
        return sum(p[:, i : i + im.shape[1]] * kx[i] for i in range(3))

    ix = sep(img, smooth, deriv)
    iy = sep(img, deriv, smooth)
    return ix, iy
