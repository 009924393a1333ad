"""Per-stage device-time breakdown of the VIO pipeline.

The headline bench measures the whole scanned rollout; this decomposes one
frame into its stages at the pipeline's actual operating point (640x480
input ÷4 → 160x120, 128 feature slots), each stage looped on-device so
host dispatch amortizes away.  Each stage is timed alone, not inside the
real step (ROADMAP queue 1, item 2 replaces this with a trace of the step).

Run on a GPU: python benchmarks/stage_profile.py [width height nfeat]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ekf_vio_tpu import engine  # noqa: E402
from ekf_vio_tpu.config import VIOConfig  # noqa: E402
from ekf_vio_tpu.core import filter as ekf  # noqa: E402
from ekf_vio_tpu.frontend import camera as cam_mod, klt, pyramid, replenish  # noqa: E402


def timeit_device(step_fn, carry, iters=100, calls=3):
    scanned = jax.jit(lambda c: jax.lax.scan(
        lambda cc, _: (step_fn(cc), None), c, None, length=iters)[0])
    jax.block_until_ready(scanned(carry))
    t0 = time.time()
    for _ in range(calls):
        r = scanned(carry)
    jax.block_until_ready(r)
    return (time.time() - t0) / (calls * iters) * 1000.0


def main():
    import bench
    import ekf_vio_tpu

    ekf_vio_tpu.enable_compile_cache()
    device = bench.require_gpu()
    w = int(sys.argv[1]) if len(sys.argv) > 1 else 160
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 120
    nf = int(sys.argv[3]) if len(sys.argv) > 3 else 128

    cfg = VIOConfig(max_features=nf)
    cam = engine.make_hashable_camera(
        [[458 / 4, 0, w / 2], [0, 458 / 4, h / 2], [0, 0, 1]], w, h)
    rng = np.random.RandomState(0)
    import scipy.ndimage as ndi

    img0 = jnp.asarray(ndi.gaussian_filter(
        rng.uniform(0, 255, (h, w)), 1.5).astype(np.float32))
    img1 = jnp.roll(img0, (1, 2), (0, 1))
    estate = engine.initialize(img0, 0.0, cfg, cam)
    filt = estate.filt
    pyr0 = pyramid.build_pyramid(img0, cfg.klt_max_pyramid_level)
    pyr1 = pyramid.build_pyramid(img1, cfg.klt_max_pyramid_level)

    report = {"device": device, "card": bench.nvidia_smi(), "unit": "ms",
              "shape": f"{w}x{h}", "slots": nf}

    # each step feeds its output back into the carry so iterations can't CSE
    report["pyramid"] = timeit_device(
        lambda im: pyramid.build_pyramid(
            im, cfg.klt_max_pyramid_level)[0] * 1e-6 + im, img1)

    prev_px = cam_mod.metric_to_pixel(cam, filt.klt_ref)

    def klt_step(pts):
        r = klt.track(pyr0, pyr1, pts, pts, filt.active, cfg)
        return pts + (r.points - pts) * 1e-3

    report["klt_track"] = timeit_device(klt_step, prev_px)

    def rep_step(px):
        cand, ok = replenish.replenish(img1, px, filt.active, cfg, nf)
        return px + (cand - px) * 1e-6

    report["replenish"] = timeit_device(rep_step, prev_px)

    report["ekf_predict"] = timeit_device(
        lambda st: ekf.predict(st, cfg, 0.01), filt)

    mc = klt.measurement_covariance_metric(cam.fx, cam.fy, nf, cfg)

    def upd_step(st):
        return ekf.update_with_feature_positions(
            st, cfg, st.feat_mu[:, :2], mc, st.active)

    report["ekf_update"] = timeit_device(upd_step, filt)

    def add_step(st):
        return ekf.add_features(st, cfg, st.feat_mu[:, :2], st.active)

    report["add_features"] = timeit_device(add_step, filt)

    def full(es):
        es2, _ = engine.step(es, img1, es.filt.t + 0.05, cfg, cam)
        return es2

    report["full_step"] = timeit_device(full, estate, iters=50)

    out = bench.out_path("stage_profile.json")
    with open(out, "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
