"""Feature replenishment: spatially-suppressed corner selection.

The reference's ``replenishFeatures`` (reference: EKFVIO.cpp:224-311)
draws filled circles of radius MIN_NEW_FEATURE_DIST around every existing
feature into a mask image, then walks cv::FAST keypoints in scan order,
skipping masked / out-of-kill-box ones and stamping accepted ones into the
mask, until NUM_FEATURES is reached.

That greedy serial stamping cannot parallelize; the data-parallel
equivalent is grid-cell binning (the standard SLAM front-end formulation): the frame
is tiled into cells of ~min_new_feature_dist, a cell is blocked when an
existing feature lies within min_dist of its center, and each free cell
contributes its single best corner — mutual separation is enforced by the
cell structure instead of a paint-and-test mask, and every cell is
processed in parallel.  Candidates are then ranked by corner response
(an improvement over the reference's arbitrary scan order) and the top
``needed`` survive.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.frontend import fast


def _cell_grid(h: int, w: int, cell: int):
    ch = -(-h // cell)
    cw = -(-w // cell)
    return ch, cw


def select_candidates(
    score_map: jnp.ndarray,     # [H, W] NMS'd corner response
    existing_px: jnp.ndarray,   # [N, 2] current feature positions (px)
    existing_valid: jnp.ndarray,  # [N] bool
    needed: jnp.ndarray,        # scalar int — how many to add
    cfg: VIOConfig,
    k_max: int,
):
    """Returns (cand_px [k_max, 2], cand_valid [k_max]) — top corners, one
    per free grid cell, ranked by response."""
    h, w = score_map.shape
    cell = max(int(cfg.min_new_feature_dist), 1)
    ch, cw = _cell_grid(h, w, cell)

    # kill-pad border rejection (EKFVIO.cpp:289, Frame.cpp:44-55)
    ys = jnp.arange(h)[:, None].astype(jnp.float32)
    xs = jnp.arange(w)[None, :].astype(jnp.float32)
    pad = float(cfg.kill_pad)
    inbox = (xs >= pad) & (ys >= pad) & (w - xs >= pad) & (h - ys >= pad)
    score = jnp.where(inbox, score_map, 0.0)

    # pad to cell multiples and take per-cell max + argmax
    score_p = jnp.pad(score, ((0, ch * cell - h), (0, cw * cell - w)))
    cells = score_p.reshape(ch, cell, cw, cell).transpose(0, 2, 1, 3).reshape(
        ch, cw, cell * cell
    )
    cell_best = jnp.max(cells, axis=-1)            # [ch, cw]
    cell_arg = jnp.argmax(cells, axis=-1)          # [ch, cw]
    cy = cell_arg // cell + jnp.arange(ch)[:, None] * cell
    cx = cell_arg % cell + jnp.arange(cw)[None, :] * cell

    # block cells whose best corner is within min_dist of an existing feature
    bx = cx.reshape(-1).astype(jnp.float32)        # [C]
    by = cy.reshape(-1).astype(jnp.float32)
    fx = existing_px[:, 0][:, None]                # [N,1]
    fy = existing_px[:, 1][:, None]
    d2 = (bx[None] - fx) ** 2 + (by[None] - fy) ** 2   # [N, C]
    near = jnp.any(
        (d2 < cfg.min_new_feature_dist**2) & existing_valid[:, None], axis=0
    )                                               # [C]
    cand_score = jnp.where(near, 0.0, cell_best.reshape(-1))

    # rank candidates by response, keep top k_max, cap at `needed`
    k = min(k_max, cand_score.shape[0])
    top_score, top_idx = jax.lax.top_k(cand_score, k)
    rank = jnp.arange(k)
    valid = (top_score > 0.0) & (rank < needed)
    px = jnp.stack([bx[top_idx], by[top_idx]], axis=-1)
    if k < k_max:
        px = jnp.pad(px, ((0, k_max - k), (0, 0)))
        valid = jnp.pad(valid, (0, k_max - k))
    return px, valid


def replenish(
    img: jnp.ndarray,
    existing_px: jnp.ndarray,
    existing_valid: jnp.ndarray,
    cfg: VIOConfig,
    k_max: int,
):
    """Full replenishment: blur → FAST → NMS → spatial selection.

    needed = num_features − #active (EKFVIO.cpp:236-244)."""
    work = fast.gaussian_blur(img, cfg.fast_blur_sigma)
    score = fast.detect(work, cfg.fast_threshold, nms=True)
    needed = cfg.num_features - jnp.sum(existing_valid.astype(jnp.int32))
    return select_candidates(score, existing_px, existing_valid, needed, cfg, k_max)
