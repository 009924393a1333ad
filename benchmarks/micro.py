"""Micro-benchmark suite — the reference's timing harnesses, reproduced.

The reference times its update at 3/103/503 features
(reference: test/test_ekf.cpp:88-141) and its numeric process Jacobian at
3/99/501 (test/jacobian_test.cpp:50-72), printing values that were never
recorded.  This script measures the same operations plus the front end
on the GPU and writes results/micro.json.

Run on a GPU: python benchmarks/micro.py
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

from ekf_vio_tpu.config import VIOConfig  # noqa: E402
from ekf_vio_tpu.core import filter as ekf, imu  # noqa: E402
from ekf_vio_tpu.frontend import fast, klt, pyramid  # noqa: E402


def timeit(fn, *args, iters=30):
    """Wall-clock per call, host dispatch included (see timeit_device for
    device time)."""
    r = fn(*args)
    jax.block_until_ready(r)
    t0 = time.time()
    for _ in range(iters):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.time() - t0) / iters * 1000.0  # ms


def timeit_device(step_fn, carry, iters=100, calls=3):
    """Pure device time: `iters` iterations of step_fn inside one
    lax.scan under a single jit — dispatch overhead amortized away."""
    scanned = jax.jit(lambda c: jax.lax.scan(
        lambda cc, _: (step_fn(cc), None), c, None, length=iters)[0])
    r = scanned(carry)
    jax.block_until_ready(r)
    t0 = time.time()
    for _ in range(calls):
        r = scanned(carry)
    jax.block_until_ready(r)
    return (time.time() - t0) / (calls * iters) * 1000.0  # ms


def full_state(cfg):
    s = ekf.init_state(cfg)
    uv = jnp.asarray(np.random.RandomState(0).uniform(-1, 1, (cfg.max_features, 2)),
                     jnp.float32)
    return ekf.add_features(s, cfg, uv, jnp.ones((cfg.max_features,), bool))


def main():
    import bench
    import ekf_vio_tpu

    ekf_vio_tpu.enable_compile_cache()
    report = {"device": bench.require_gpu(), "card": bench.nvidia_smi(),
              "unit": "ms"}

    # --- EKF update at the reference's feature counts (test_ekf.cpp:88-141)
    for n in (3, 103, 503):
        cfg = VIOConfig(max_features=n)
        s = full_state(cfg)
        cov = jnp.tile(jnp.eye(2) * 1e-5, (n, 1, 1))
        report[f"ekf_update_{n}feat_device"] = timeit_device(
            lambda st: ekf.update_with_feature_positions(
                st, cfg, st.feat_mu[:, :2], cov, st.active), s)

    # --- predict (exact Jacobians + blocked covariance;
    #     jacobian_test.cpp:50-72 analog at 3/99/501)
    for n in (3, 99, 501):
        cfg = VIOConfig(max_features=n)
        s = full_state(cfg)
        report[f"ekf_predict_{n}feat_device"] = timeit_device(
            lambda st: ekf.predict(st, cfg, 0.05), s)

    # --- partial-measurement update (half the features fail;
    #     test_ekf.cpp partially-measured case) — masked full-shape
    #     factorization vs the compacted (budget) path that gathers the
    #     measured subset first (TightlyCoupledEKF.cpp:486-541 semantics)
    cfg = VIOConfig(max_features=103)
    s = full_state(cfg)
    cov = jnp.tile(jnp.eye(2) * 1e-5, (103, 1, 1))
    passed = jnp.arange(103) % 2 == 0
    report["ekf_update_103feat_half_measured"] = timeit_device(
        lambda st: ekf.update_with_feature_positions(
            st, cfg, st.feat_mu[:, :2], cov, passed), s)
    report["ekf_update_103feat_half_measured_budget64"] = timeit_device(
        lambda st: ekf.update_with_feature_positions(
            st, cfg, st.feat_mu[:, :2], cov, passed, budget=64), s)
    cfg503 = VIOConfig(max_features=503)
    s503 = full_state(cfg503)
    cov503 = jnp.tile(jnp.eye(2) * 1e-5, (503, 1, 1))
    passed503 = jnp.arange(503) % 4 == 0  # 126 of 503 measured
    report["ekf_update_503feat_quarter_measured"] = timeit_device(
        lambda st: ekf.update_with_feature_positions(
            st, cfg503, st.feat_mu[:, :2], cov503, passed503), s503)
    report["ekf_update_503feat_quarter_measured_budget128"] = timeit_device(
        lambda st: ekf.update_with_feature_positions(
            st, cfg503, st.feat_mu[:, :2], cov503, passed503, budget=128),
        s503)

    # --- KLT @ 640x480, 128 features
    rng = np.random.RandomState(0)
    import scipy.ndimage as ndi

    img = ndi.gaussian_filter(rng.uniform(0, 255, (480, 640)), 1.5).astype(np.float32)
    img2 = np.roll(img, (2, 3), (0, 1))
    cfg = VIOConfig(max_features=128)
    pa = pyramid.build_pyramid(jnp.asarray(img), 3)
    pb = pyramid.build_pyramid(jnp.asarray(img2), 3)
    pts = jnp.asarray(rng.uniform(40, 400, (128, 2)).astype(np.float32))
    v = jnp.ones(128, bool)
    f = jax.jit(lambda a, b, p: klt.track(a, b, p, p, v, cfg))
    report["klt_640x480_128feat"] = timeit(f, pa, pb, pts)
    fx = jax.jit(lambda a, b, p: klt.track_xla(a, b, p, p, v, cfg))
    report["klt_640x480_128feat_xla"] = timeit(fx, pa, pb, pts)

    # --- FAST 640x480
    x = jnp.asarray(img)
    report["fast_640x480"] = timeit(jax.jit(lambda i: fast.detect(i, 50.0)), x)

    # --- pyramid build
    report["pyramid_640x480"] = timeit(
        jax.jit(lambda i: pyramid.build_pyramid(i, 3)), x)

    # --- IMU batch (10 samples @128 slots)
    cfg = VIOConfig(max_features=128)
    s = full_state(cfg)
    g_w = jnp.array([0.0, 0.0, -9.81])
    batch = imu.ImuSample(
        dt=jnp.full((10,), 0.005, jnp.float32),
        gyro=jnp.tile(jnp.array([0.1, 0.0, 0.2]), (10, 1)),
        accel=jnp.tile(jnp.array([0.0, 0.0, 9.81]), (10, 1)))
    f = jax.jit(lambda st, b: imu.propagate_imu_batch(st, cfg, b, g_w))
    report["imu_batch10_128feat"] = timeit(f, s, batch)

    out_path = bench.out_path("micro.json")
    with open(out_path, "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
