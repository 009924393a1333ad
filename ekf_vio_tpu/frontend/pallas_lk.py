"""Fused pyramidal-LK tracker: one GPU kernel for the whole pyramid.

Same semantics as the XLA tracker in frontend/klt.py (``_track_level``
over the pyramid), which stays the reference: 21x21 window, per-level
iteration cap 30, eps 0.01, min-eigen gate at level 0, +-5 px per-level
search margin, initial-flow seeding (KLTTracker.cpp:61-64,
Params.h:36,103-104).

Why a kernel.  LK is a data-dependent loop of up to 30 iterations per
level of tiny per-feature arithmetic.  XLA runs each iteration of
``_track_level``'s ``lax.while_loop`` as separate launches and fetches the
loop predicate to the host on every trip; here every iteration of every
level runs inside one launch.

Design (Pallas through Triton, after OpenCV's CUDA sparse pyramidal LK):

* one program per feature, its 21x21 window flattened onto a 512-wide
  block (441 live lanes);
* the window is read straight from the level image by computed offsets
  (bilinear taps are gathers; the images are a few hundred KB and stay
  in L2), so no patch is ever materialized;
* template and Scharr gradients are sampled once per level, the 2x2
  normal matrix is inverted once, and the iterations run in-kernel with
  the feature's own convergence test;
* the index arithmetic reproduces the reference's border model exactly:
  a 32x32 patch anchored at floor(pos) - 15, clamped to the image, with
  window taps clamped to the patch.  Intensities are rounded to bf16 like
  the reference's patch extraction, so both paths see the same pixels.

Batching: ``jax.custom_batching.custom_vmap`` maps a vmapped call onto
one launch over all lanes' features (parallel/batched_engine.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ekf_vio_tpu.frontend import pyramid

_MARGIN = 5            # px search range beyond the seed per level
_MAX_WINDOW_PIXELS = 1024  # window lanes per program (registers bound it)
_NUM_WARPS = 4
_BIG = float(2 ** 20)  # clamp before float->int: keeps indices defined


def supported(n: int, win: int = 21) -> bool:
    """Whether the kernel covers this call: any image and feature count,
    windows up to 32x32 (the flattened window must fit one block)."""
    return n > 0 and 2 <= win and win * win <= _MAX_WINDOW_PIXELS


def _ifloor(x):
    return jnp.floor(jnp.clip(x, -_BIG, _BIG)).astype(jnp.int32)


def _lk_kernel(*refs, shapes, n_per_lane, win, iters, eps, min_eigen):
    n_lv = len(shapes)
    prev_refs, cur_refs = refs[:n_lv], refs[n_lv:2 * n_lv]
    (qx_ref, qy_ref, gx_ref, gy_ref, valid_ref,
     ox_ref, oy_ref, ok_ref, err_ref, eig_ref) = refs[2 * n_lv:]

    f = pl.program_id(0)
    lane = lax.div(f, n_per_lane)
    half = (win - 1) // 2
    m = _MARGIN
    p = win + 2 * m + 1                      # reference patch side
    wp = pl.next_power_of_2(win * win)
    k = lax.broadcasted_iota(jnp.int32, (wp,), 0)
    wi = lax.div(k, win)                     # window row
    wj = lax.rem(k, win)                     # window col
    live_px = k < win * win
    area = float(win * win)

    def wsum(x):
        return jnp.sum(jnp.where(live_px, x, 0.0))

    px0, py0 = qx_ref[f], qy_ref[f]
    top = n_lv - 1
    gx = gx_ref[f] / float(2 ** top)
    gy = gy_ref[f] / float(2 ** top)
    ok = valid_ref[f] > 0

    for lvl in range(top, -1, -1):
        h, w = shapes[lvl]
        prev_ref, cur_ref = prev_refs[lvl], cur_refs[lvl]
        s = float(2 ** lvl)
        qx, qy = px0 / s, py0 / s

        def pix(ref, r, c):
            rr = jnp.clip(r, 0, h - 1)
            cc = jnp.clip(c, 0, w - 1)
            return ref[lane, rr, cc].astype(jnp.float32)

        def taps(anchor, center, idx):
            """Window base and fraction along one axis, and the two tap
            coordinates (patch-clamped, then offset by the anchor)."""
            base = center - half
            b0 = jnp.floor(base)
            b0i = _ifloor(base)
            a = anchor + jnp.clip(b0i + idx, 0, p - 1)
            b = anchor + jnp.clip(b0i + idx + 1, 0, p - 1)
            return a, b, base - b0

        def lerp(v00, v01, v10, v11, fx, fy):
            return ((1.0 - fy) * ((1.0 - fx) * v00 + fx * v01)
                    + fy * ((1.0 - fx) * v10 + fx * v11))

        # --- template and gradients around the prev position
        ax = _ifloor(qx) - (half + m)
        ay = _ifloor(qy) - (half + m)
        ca, _, tfx = taps(ax, qx - ax.astype(jnp.float32), wj)
        ra, _, tfy = taps(ay, qy - ay.astype(jnp.float32), wi)
        # the template's taps sit inside the patch (base = m + frac), so
        # its second tap is a + 1 and the Scharr stencil reads the 4x4
        # neighbourhood [a-1, a+2] of the image, clamped per pixel
        nb = {(dy, dx): pix(prev_ref, ra + dy, ca + dx)
              for dy in (-1, 0, 1, 2) for dx in (-1, 0, 1, 2)}
        sm = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)

        def grad_x(y, x):
            return sum(sm[i] * (nb[(y + i - 1, x + 1)] - nb[(y + i - 1, x - 1)])
                       for i in range(3))

        def grad_y(y, x):
            return sum(sm[i] * (nb[(y + 1, x + i - 1)] - nb[(y - 1, x + i - 1)])
                       for i in range(3))

        tpl = lerp(nb[(0, 0)], nb[(0, 1)], nb[(1, 0)], nb[(1, 1)], tfx, tfy)
        ix = lerp(grad_x(0, 0), grad_x(0, 1), grad_x(1, 0), grad_x(1, 1),
                  tfx, tfy)
        iy = lerp(grad_y(0, 0), grad_y(0, 1), grad_y(1, 0), grad_y(1, 1),
                  tfx, tfy)

        gxx, gxy, gyy = wsum(ix * ix), wsum(ix * iy), wsum(iy * iy)
        det_half = jnp.sqrt(jnp.maximum((gxx - gyy) ** 2 / 4.0 + gxy * gxy,
                                        0.0))
        min_eig = ((gxx + gyy) / 2.0 - det_half) / area
        det = gxx * gyy - gxy * gxy
        inv_ok = det > 1e-12
        det_safe = jnp.where(inv_ok, det, 1.0)
        i00, i01, i11 = gyy / det_safe, -gxy / det_safe, gxx / det_safe

        # --- search window in the cur image, anchored at the incoming guess
        g0x, g0y = gx, gy
        cx0 = _ifloor(g0x) - (half + m)
        cy0 = _ifloor(g0y) - (half + m)
        cx0f, cy0f = cx0.astype(jnp.float32), cy0.astype(jnp.float32)

        def cur_window(x, y):
            c_a, c_b, fx = taps(cx0, x - cx0f, wj)
            r_a, r_b, fy = taps(cy0, y - cy0f, wi)
            return lerp(pix(cur_ref, r_a, c_a), pix(cur_ref, r_a, c_b),
                        pix(cur_ref, r_b, c_a), pix(cur_ref, r_b, c_b),
                        fx, fy)

        def body(carry):
            it, x, y, _ = carry
            r = tpl - cur_window(x, y)
            bx, by = wsum(r * ix), wsum(r * iy)
            dx = i00 * bx + i01 * by
            dy = i01 * bx + i11 * by
            return it + 1, x + dx, y + dy, dx * dx + dy * dy < eps * eps

        def cond(carry):
            it, _, _, done = carry
            return (it < iters) & jnp.logical_not(done)

        # features that cannot step (invalid, lost at a coarser level,
        # singular normal matrix) start "done" and keep their guess
        _, gx, gy, _ = lax.while_loop(
            cond, body, (jnp.int32(0), gx, gy, jnp.logical_not(ok & inv_ok)))

        within = (jnp.abs(gx - g0x) <= m) & (jnp.abs(gy - g0y) <= m)
        in_bounds = ((gx >= 1) & (gy >= 1) & (gx < w - 2) & (gy < h - 2)
                     & (qx >= 1) & (qy >= 1) & (qx < w - 2) & (qy < h - 2))
        ok = ok & in_bounds & inv_ok & within
        if lvl > 0:
            gx, gy = gx * 2.0, gy * 2.0
        else:
            ok = ok & (min_eig > min_eigen)
            eig0 = min_eig
            err0 = wsum(jnp.abs(tpl - cur_window(gx, gy))) / area

    ox_ref[f] = gx
    oy_ref[f] = gy
    ok_ref[f] = ok.astype(jnp.int32)
    err_ref[f] = err0
    eig_ref[f] = eig0


@functools.partial(jax.jit, static_argnames=(
    "win", "iters", "eps", "min_eigen", "interpret"))
def _track_batched(prev_levels, cur_levels, prev_pts, init_pts, valid,
                   *, win, iters, eps, min_eigen, interpret):
    """prev_levels/cur_levels: tuples of [B, Hl, Wl] level images (finest
    first; only the levels the tracker uses).  prev_pts/init_pts:
    [B, N, 2] level-0 px.  valid: [B, N] bool.
    Returns (points [B,N,2], ok [B,N], err [B,N], min_eig [B,N])."""
    b, n, _ = prev_pts.shape
    bn = b * n
    # dead slots may hold NaN; the kernel sees finite coordinates only
    finite = jnp.isfinite(prev_pts).all(-1) & jnp.isfinite(init_pts).all(-1)
    use = valid & finite
    q = jnp.where(use[..., None], prev_pts, 0.0).reshape(bn, 2)
    g = jnp.where(use[..., None], init_pts, 0.0).reshape(bn, 2)
    shapes = tuple(l.shape[1:] for l in prev_levels)
    kernel = functools.partial(
        _lk_kernel, shapes=shapes, n_per_lane=n, win=win, iters=iters,
        eps=eps, min_eigen=min_eigen)
    f32 = jax.ShapeDtypeStruct((bn,), jnp.float32)
    ox, oy, ok, err, eig = pl.pallas_call(
        kernel,
        grid=(bn,),
        out_shape=(f32, f32, jax.ShapeDtypeStruct((bn,), jnp.int32), f32,
                   f32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="pallas_lk",
    )(*(l.astype(jnp.bfloat16) for l in prev_levels),
      *(l.astype(jnp.bfloat16) for l in cur_levels),
      q[:, 0], q[:, 1], g[:, 0], g[:, 1], use.reshape(bn).astype(jnp.int32))
    pts = jnp.where(use[..., None], jnp.stack([ox, oy], -1).reshape(b, n, 2),
                    init_pts)
    return (pts, (ok > 0).reshape(b, n), err.reshape(b, n),
            eig.reshape(b, n))


@functools.lru_cache(maxsize=16)
def _make_tracker(win, iters, eps, min_eigen, interpret):
    """custom_vmap-wrapped tracker for static LK parameters.

    The single-sequence call runs the batched kernel at B=1; a vmap over
    it (parallel/batched_engine.py) re-targets the batched kernel instead
    of lifting the grid."""
    kw = dict(win=win, iters=iters, eps=eps, min_eigen=min_eigen,
              interpret=interpret)

    @jax.custom_batching.custom_vmap
    def track_one(prev_levels, cur_levels, prev_pts, init_pts, valid):
        out = _track_batched(
            tuple(l[None] for l in prev_levels),
            tuple(l[None] for l in cur_levels),
            prev_pts[None], init_pts[None], valid[None], **kw)
        return tuple(o[0] for o in out)

    @track_one.def_vmap
    def _rule(axis_size, in_batched, prev_levels, cur_levels,
              prev_pts, init_pts, valid):
        def bc(x, batched):
            return x if batched else jnp.broadcast_to(
                x, (axis_size,) + x.shape)

        out = _track_batched(
            tuple(bc(l, b) for l, b in zip(prev_levels, in_batched[0])),
            tuple(bc(l, b) for l, b in zip(cur_levels, in_batched[1])),
            bc(prev_pts, in_batched[2]), bc(init_pts, in_batched[3]),
            bc(valid, in_batched[4]), **kw)
        return out, (True, True, True, True)

    return track_one


def track(prev_pyr, cur_pyr, prev_pts, init_pts, valid, cfg,
          interpret=False):
    """Fused pyramid track.  Same contract as klt.track minus the
    TrackResult wrapper: returns (points, status, error, min_eig) in
    level-0 px coordinates."""
    win = cfg.klt_window_size
    if not supported(prev_pts.shape[0], win):
        raise ValueError(
            f"pallas_lk.track called outside supported() (win={win}, "
            f"n={prev_pts.shape[0]}); use klt.track for dispatch")
    top = pyramid.top_tracked_level(prev_pyr, win)
    tracker = _make_tracker(win, cfg.klt_iterations, cfg.klt_eps,
                            cfg.klt_min_eigen, interpret)
    return tracker(tuple(prev_pyr[: top + 1]), tuple(cur_pyr[: top + 1]),
                   prev_pts, init_pts, valid)

