"""Pyramidal Lucas-Kanade feature tracker — batched, jit-compiled.

Reimplements the tracking semantics the reference gets from
cv::calcOpticalFlowPyrLK (reference: KLTTracker.cpp:61-64):

* 21x21 window, 3 pyramid levels, 30 iterations, eps 0.01
  (Params.h:36,103-104)
* OPTFLOW_USE_INITIAL_FLOW — the search is seeded at the EKF-predicted
  feature positions (KLTTracker.cpp:53-59), which is what couples the
  front-end to the filter
* minimum-eigenvalue rejection: min_eig(G)/window_area < threshold fails
  the feature (KLT_MIN_EIGEN, Params.h:36)
* per-feature constant 2x2 measurement covariance converted to metric by
  1/f² (KLTTracker.cpp:75-84)

Every feature is a row of a batch: patch extraction and window sampling
are batched products, the normal equations are closed-form 2x2 solves,
and the iteration loop is a ``lax.while_loop`` with a per-feature
convergence mask (no data-dependent shapes).  The pyramid level loop is a
static Python unroll (shapes differ per level).  On a GPU ``track``
dispatches to the fused kernel in frontend/pallas_lk.py; this plain path
is its reference.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.frontend import pallas_lk, pyramid


class TrackResult(NamedTuple):
    points: jnp.ndarray   # [N, 2] tracked positions (px, level-0 coords)
    status: jnp.ndarray   # [N] bool — tracked successfully
    error: jnp.ndarray    # [N] mean |residual| over the window
    min_eig: jnp.ndarray  # [N] min eigenvalue of G / window area (level 0)


def sample_bilinear(img: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation. img: [H, W]; pts: [..., 2] as (x, y).

    Out-of-range coordinates clamp to the border (callers bound-check
    separately); implemented as a flat gather.
    """
    h, w = img.shape
    x = pts[..., 0]
    y = pts[..., 1]
    x0 = jnp.clip(jnp.floor(x), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y), 0, h - 2)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    flat = img.reshape(-1)
    idx = y0i * w + x0i
    v00 = jnp.take(flat, idx)
    v01 = jnp.take(flat, idx + 1)
    v10 = jnp.take(flat, idx + w)
    v11 = jnp.take(flat, idx + w + 1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _window_offsets(win: int) -> jnp.ndarray:
    """[win², 2] integer offsets centered on 0."""
    half = (win - 1) // 2
    r = jnp.arange(win, dtype=jnp.float32) - half
    ox, oy = jnp.meshgrid(r, r, indexing="xy")
    return jnp.stack([ox.reshape(-1), oy.reshape(-1)], axis=-1)


# --------------------------------------------------------------------------
# Gather-free sampling: one-hot matmul patch extraction + window resampling.
#
# Two facts make sampling a pair of matrix products: (a) a patch is a
# row-selection × image × column-selection product, and (b) an LK window
# moves *rigidly*, so one shared fractional offset serves every pixel —
# bilinear resampling of the whole window is exactly  W = Ry · patch · Cxᵀ
# with Ry/Cx built from interpolating one-hot rows.  The iteration loop
# contains no gathers at all.
# --------------------------------------------------------------------------


def _extract_patches(img: jnp.ndarray, anchor: jnp.ndarray, p: int,
                     sample_dtype=jnp.bfloat16) -> jnp.ndarray:
    """[N, p, p] integer-aligned patches via one-hot matmuls.

    anchor: [N, 2] int32 top-left (x0, y0); rows/cols clamp-replicate at
    the image border (the same border model as a padded pyramid).

    These image-height/width-sized matmuls are the dominant FLOPs of the
    tracker; they run at ``sample_dtype`` (default bf16).  One-hot
    selectors are *exact* in bf16, so the extracted patch is the
    bf16-rounded image — selection, not arithmetic, happens here.  The
    subsequent LK normal equations stay in f32.
    """
    h, w = img.shape
    ar = jnp.arange(p)
    ys = jnp.clip(anchor[:, 1, None] + ar[None], 0, h - 1)  # [N,p]
    xs = jnp.clip(anchor[:, 0, None] + ar[None], 0, w - 1)
    ry = jax.nn.one_hot(ys, h, dtype=sample_dtype)          # [N,p,H]
    cx = jax.nn.one_hot(xs, w, dtype=sample_dtype)          # [N,p,W]
    tmp = jnp.einsum("nph,hw->npw", ry, img.astype(sample_dtype),
                     preferred_element_type=sample_dtype)
    return jnp.einsum("npw,nqw->npq", tmp, cx,
                      preferred_element_type=jnp.float32)


def _lerp_selector(i0: jnp.ndarray, frac: jnp.ndarray, win: int, p: int, dtype):
    """[N, win, p] bilinear row-selection matrices: row i interpolates
    patch rows (i0+i, i0+i+1) with weight frac."""
    idx = i0[:, None] + jnp.arange(win)[None]               # [N,win]
    a = jax.nn.one_hot(jnp.clip(idx, 0, p - 1), p, dtype=dtype)
    b = jax.nn.one_hot(jnp.clip(idx + 1, 0, p - 1), p, dtype=dtype)
    f = frac[:, None, None]
    return a * (1.0 - f) + b * f


def _sample_windows(patch: jnp.ndarray, center: jnp.ndarray, win: int) -> jnp.ndarray:
    """Bilinear [N, win, win] windows centered at `center` (within-patch
    float coords), as two small matmuls per feature."""
    p = patch.shape[-1]
    base = center - (win - 1) / 2.0
    bx0 = jnp.floor(base[:, 0])
    by0 = jnp.floor(base[:, 1])
    ry = _lerp_selector(by0.astype(jnp.int32), base[:, 1] - by0, win, p, patch.dtype)
    cx = _lerp_selector(bx0.astype(jnp.int32), base[:, 0] - bx0, win, p, patch.dtype)
    tmp = jnp.einsum("nip,npq->niq", ry, patch)
    return jnp.einsum("niq,njq->nij", tmp, cx)


def _patch_gradients(patch: jnp.ndarray):
    """Scharr gradients on [N, p, p] patches (smooth [3,10,3]/32 ⊗
    derive [-1,0,1]), edge-replicated — dense shifts, no convolution
    over the full image."""
    smooth = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    deriv = (-1.0, 0.0, 1.0)

    def sep(x, ky, kx):
        xp = jnp.pad(x, ((0, 0), (1, 1), (0, 0)), mode="edge")
        x = sum(xp[:, i : i + x.shape[1], :] * ky[i] for i in range(3))
        xp = jnp.pad(x, ((0, 0), (0, 0), (1, 1)), mode="edge")
        return sum(xp[:, :, i : i + x.shape[2]] * kx[i] for i in range(3))

    return sep(patch, smooth, deriv), sep(patch, deriv, smooth)


_SEARCH_MARGIN = 5  # px of in-patch search range per level beyond the seed


def _track_level(prev_img, cur_img, q, g, valid, cfg: VIOConfig):
    """One pyramid level of LK for all N features — gather-free.

    q: [N,2] feature positions in *this level's* prev image.
    g: [N,2] current guesses in this level's cur image.
    Returns (g_new, min_eig, mean_abs_residual, ok).

    Per-level displacement beyond the incoming guess is bounded by the
    patch search margin (coarse levels absorb large motion; each finer
    level only refines) — a feature that runs off its patch is declared
    lost, which subsumes the reference's track-failure status.
    """
    win = cfg.klt_window_size
    half = (win - 1) // 2
    m = _SEARCH_MARGIN
    p = win + 2 * m + 1  # +1 for the bilinear neighbor
    h, w = prev_img.shape
    n = q.shape[0]

    # template patch around the prev position
    a0 = jnp.floor(q).astype(jnp.int32) - (half + m)
    prev_patch = _extract_patches(prev_img, a0, p)
    pix, piy = _patch_gradients(prev_patch)
    c_prev = q - a0.astype(q.dtype)  # within-patch center (= half+m+frac)

    template = _sample_windows(prev_patch, c_prev, win).reshape(n, -1)
    ix = _sample_windows(pix, c_prev, win).reshape(n, -1)
    iy = _sample_windows(piy, c_prev, win).reshape(n, -1)

    gxx = jnp.sum(ix * ix, axis=-1)
    gxy = jnp.sum(ix * iy, axis=-1)
    gyy = jnp.sum(iy * iy, axis=-1)

    # min eigenvalue of [[gxx, gxy],[gxy, gyy]] / window area
    tr = gxx + gyy
    det_half = jnp.sqrt(jnp.maximum((gxx - gyy) ** 2 / 4.0 + gxy * gxy, 0.0))
    min_eig = (tr / 2.0 - det_half) / (win * win)

    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-12
    det_safe = jnp.where(inv_ok, det, 1.0)
    i00 = gyy / det_safe
    i01 = -gxy / det_safe
    i11 = gxx / det_safe

    # search patch around the incoming guess in the current frame
    g0 = g
    c0 = jnp.floor(g0).astype(jnp.int32) - (half + m)
    cur_patch = _extract_patches(cur_img, c0, p)
    c0f = c0.astype(g.dtype)

    def body(carry):
        it, g, done = carry
        cur = _sample_windows(cur_patch, g - c0f, win).reshape(n, -1)
        r = template - cur  # prev − cur
        bx = jnp.sum(r * ix, axis=-1)
        by = jnp.sum(r * iy, axis=-1)
        delta = jnp.stack([i00 * bx + i01 * by, i01 * bx + i11 * by], axis=-1)
        step_ok = valid & ~done & inv_ok
        g = g + jnp.where(step_ok[:, None], delta, 0.0)
        done = done | (jnp.sum(delta * delta, axis=-1) < cfg.klt_eps**2)
        return it + 1, g, done

    def cond(carry):
        it, _, done = carry
        return (it < cfg.klt_iterations) & ~jnp.all(done | ~valid)

    done0 = jnp.zeros(n, bool)
    _, g, _ = jax.lax.while_loop(cond, body, (0, g, done0))

    cur = _sample_windows(cur_patch, g - c0f, win).reshape(n, -1)
    err = jnp.mean(jnp.abs(template - cur), axis=-1)

    # lost if the point ran off its search patch, or left the level image
    # (windows may overhang the image — sampling clamp-replicates, the
    # same border model as OpenCV's padded pyramid; the caller's kill-pad
    # test, KLTTracker.cpp:73, is the real border gate).
    within_patch = jnp.all(jnp.abs(g - g0) <= m, axis=-1)
    in_bounds = (
        (g[:, 0] >= 1)
        & (g[:, 1] >= 1)
        & (g[:, 0] < w - 2)
        & (g[:, 1] < h - 2)
        & (q[:, 0] >= 1)
        & (q[:, 1] >= 1)
        & (q[:, 0] < w - 2)
        & (q[:, 1] < h - 2)
    )
    return g, min_eig, err, in_bounds & inv_ok & within_patch


def selected_backend(level0_shape, n: int, cfg: VIOConfig) -> str:
    """Which tracker ``track`` dispatches to: 'pallas_lk' (the fused GPU
    kernel, frontend/pallas_lk.py) on a GPU when the kernel covers the
    shapes, else 'xla' (``track_xla``).

    A static-shape rule, so benchmarks can query it before running and
    report what they measured; ``track`` routes through it, so the two
    cannot diverge.
    """
    if (jax.default_backend() == "gpu"
            and pallas_lk.supported(n, cfg.klt_window_size)):
        return "pallas_lk"
    return "xla"


def track(
    prev_pyr: tuple,
    cur_pyr: tuple,
    prev_pts: jnp.ndarray,
    init_pts: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: VIOConfig,
) -> TrackResult:
    """Pyramidal LK over all features at once.

    prev_pyr / cur_pyr: tuples from build_pyramid (levels+1 images).
    prev_pts: [N,2] px positions in the previous frame (level 0).
    init_pts: [N,2] px initial guesses in the current frame — the
      EKF-predicted positions (OPTFLOW_USE_INITIAL_FLOW seeding,
      KLTTracker.cpp:53-64).
    valid: [N] bool — which rows are real features.
    """
    args = (prev_pyr, cur_pyr, prev_pts, init_pts, valid)
    if selected_backend(prev_pyr[0].shape, prev_pts.shape[0], cfg) == "xla":
        return track_xla(*args, cfg)

    def fused(*a):
        return TrackResult(*pallas_lk.track(*a, cfg))

    # chosen again when lowering, so work placed on the host CPU of a GPU
    # process still takes the plain path
    return jax.lax.platform_dependent(
        *args, cuda=fused, default=lambda *a: track_xla(*a, cfg))


def track_xla(prev_pyr, cur_pyr, prev_pts, init_pts, valid,
              cfg: VIOConfig) -> TrackResult:
    """The plain tracker: ``_track_level`` from the coarsest used level
    down.  It runs wherever the kernel does not, and is the reference the
    kernel is tested against."""
    top = pyramid.top_tracked_level(prev_pyr, cfg.klt_window_size)
    g = init_pts / float(2**top)
    ok = valid
    for lvl in range(top, -1, -1):
        q = prev_pts / float(2**lvl)
        g, min_eig, err, inb = _track_level(
            prev_pyr[lvl], cur_pyr[lvl], q, g, ok, cfg)
        if lvl > 0:
            g = g * 2.0
        else:
            inb = inb & (min_eig > cfg.klt_min_eigen)
        ok = ok & inb
    return TrackResult(points=g, status=ok, error=err, min_eig=min_eig)


def measurement_covariance_metric(cam_fx, cam_fy, n: int, cfg: VIOConfig):
    """Constant per-feature 2x2 R in metric units: diag(σ²_px) scaled by
    1/f² (KLTTracker.cpp:75-84, estimateUncertainty cpp:100-106)."""
    var = jnp.stack(
        [cfg.klt_measurement_variance_px / (cam_fx * cam_fx),
         cfg.klt_measurement_variance_px / (cam_fy * cam_fy)]
    )
    return jnp.tile(jnp.diag(var)[None], (n, 1, 1))


def estimate_uncertainty_sample_based(
    prev_img, cur_img, mu_ref, mu, k: float = 0.01, window_size: int = 5
):
    """Sample-based SSD covariance estimator.

    Port of the reference's (written but unused) estimator
    (KLTTracker.cpp:111-175): SSD between the reference patch and patches
    sampled on a 5x5 grid of ±10px offsets, Gaussian-weighted into a 2x2
    covariance.  Batched over features.
    """
    offs = jnp.arange(-10.0, 10.1, 5.0)
    du, dv = jnp.meshgrid(offs, offs, indexing="ij")
    duv = jnp.stack([du.reshape(-1), dv.reshape(-1)], -1)  # [25, 2]
    woffs = _window_offsets(window_size)  # [ws², 2]

    ref = sample_bilinear(prev_img, mu_ref[:, None, :] + woffs[None])  # [N,ws²]
    # samples: [N, 25, ws²]
    pts = mu[:, None, None, :] + duv[None, :, None, :] + woffs[None, None, :, :]
    smp = sample_bilinear(cur_img, pts)
    ssd = jnp.mean((ref[:, None, :] - smp) ** 2, axis=-1)  # [N, 25]
    rd = jnp.exp(-k * ssd)
    s = jnp.sum(rd, axis=-1)
    xx = jnp.sum(rd * (duv[None, :, 0] ** 2), axis=-1) / s
    yy = jnp.sum(rd * (duv[None, :, 1] ** 2), axis=-1) / s
    xy = jnp.sum(rd * duv[None, :, 0] * duv[None, :, 1], axis=-1) / s
    return jnp.stack(
        [jnp.stack([xx, xy], -1), jnp.stack([xy, yy], -1)], axis=-2
    )  # [N, 2, 2]
