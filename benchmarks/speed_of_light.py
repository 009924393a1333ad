"""Speed-of-light analysis of the hot kernels on one GPU.

The north star demands "measure covariance-propagation and KLT kernel
speed-of-light per chip".  The reference's timing harnesses print raw
wall-clock only (reference: test/test_ekf.cpp:88-141,
test/jacobian_test.cpp:50-72); this script adds the missing roofline:

1. **Attainable ceilings are measured, not quoted.**  The matmul rate
   at the filter's mandatory f32 precision (see
   core/dynamics.propagate_covariance — reduced-precision passes NaN the
   filter) is measured with a large square matmul; attainable device
   bandwidth with a large saxpy.  The card's published peaks (``PEAKS``,
   keyed by ``device_kind``) are reported beside them; a card missing
   from the table is an error.

2. **Each hot kernel gets an analytic FLOP + byte count** and the
   resulting roofline bound t_sol = max(flops/peak_flops,
   bytes/peak_bw); achieved fraction = t_sol / t_measured.

Kernels covered (device time measured via scan-amortized jit, no host
dispatch in the number):

* covariance propagation  Σ ← FΣFᵀ + Q  at N = 128/256/501 slots
  (D = 406/790/1525) — the predict's dominant cost
  (TightlyCoupledEKF.cpp:113-114 is the reference's sparse analog);
* full masked EKF update at the same sizes (S assembly + Cholesky +
  gain solve + Joseph form, TightlyCoupledEKF.cpp:559-596 analog);
* the fused pyramidal-LK tracker kernel (frontend/pallas_lk.py) at
  640x480 / 128 features (KLTTracker.cpp:61-64 analog), counted in
  algorithmic FLOPs (what LK fundamentally needs);
* the compound IMU interval propagation (10 samples, 128 slots).

Writes results/speed_of_light.json.  Run on a GPU:
    python benchmarks/speed_of_light.py
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

# Published dense peaks per device_kind (NVIDIA H100 SXM data sheet, no
# sparsity, at the full 700 W power limit): FLOP/s and device bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def published_peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for {device_kind!r}; add the "
                       "card to PEAKS with its source")
    return PEAKS[device_kind]


def timeit_device(step_fn, carry, iters=100, calls=3):
    """Pure device seconds per step: iters steps inside one scanned jit."""
    scanned = jax.jit(lambda c: jax.lax.scan(
        lambda cc, _: (step_fn(cc), None), c, None, length=iters)[0])
    r = scanned(carry)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(calls):
        r = scanned(carry)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / (calls * iters)


def measure_matmul_peak_f32(m=4096, iters=20):
    """Attainable f32 (HIGHEST precision) matmul FLOP/s — the precision
    the covariance algebra must run at."""
    a = jnp.asarray(np.random.randn(m, m), jnp.float32)

    @jax.default_matmul_precision("float32")
    def step(x):
        return 0.5 * (x @ a)  # rescale to keep values bounded across iters

    t = timeit_device(step, a, iters=iters, calls=3)
    return 2.0 * m**3 / t


def measure_matmul_peak_bf16(m=4096, iters=20):
    a = jnp.asarray(np.random.randn(m, m), jnp.bfloat16)

    def step(x):
        return (0.5 * (x @ a)).astype(jnp.bfloat16)

    t = timeit_device(step, a, iters=iters, calls=3)
    return 2.0 * m**3 / t


def measure_hbm_bw(nbytes=512 * 1024 * 1024, iters=10):
    """Attainable HBM bandwidth: y = x + c reads 4 bytes + writes 4 per
    element → traffic = 2 * nbytes per step."""
    n = nbytes // 4
    x = jnp.zeros((n,), jnp.float32)

    def step(v):
        return v + 1.0

    t = timeit_device(step, x, iters=iters, calls=3)
    return 2.0 * nbytes / t


def roofline(flops, bytes_, t_meas, peak_flops, peak_bw):
    t_compute = flops / peak_flops
    t_memory = bytes_ / peak_bw
    t_sol = max(t_compute, t_memory)
    return {
        "flops": flops,
        "bytes": bytes_,
        "t_measured_us": round(t_meas * 1e6, 2),
        "t_sol_us": round(t_sol * 1e6, 2),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "achieved_frac_of_sol": round(t_sol / t_meas, 4),
        "achieved_tflops": round(flops / t_meas / 1e12, 3),
        "achieved_gbps": round(bytes_ / t_meas / 1e9, 2),
    }


def full_state(cfg):
    s = ekf.init_state(cfg)
    uv = jnp.asarray(
        np.random.RandomState(0).uniform(-1, 1, (cfg.max_features, 2)),
        jnp.float32)
    return ekf.add_features(s, cfg, uv, jnp.ones((cfg.max_features,), bool))


def bench_cov_propagate(n, peak_flops, peak_bw):
    """Σ ← FΣFᵀ + Q as implemented (dense F, two [D,D] matmuls)."""
    cfg = VIOConfig(max_features=n)
    st = full_state(cfg)
    d = st.state_dim

    def step(s):
        return ekf.predict(s, cfg, 0.05)

    t = timeit_device(step, st, iters=50)
    # two dense [D,D]@[D,D] products dominate; Jacobian-block assembly and
    # the symmetrization are O(D^2).
    flops = 4.0 * d**3
    bytes_ = 4 * d * d * 4.0  # F, Sigma in; product out; symmetrized out
    return d, roofline(flops, bytes_, t, peak_flops, peak_bw)


def bench_update(n, peak_flops, peak_bw, measured_frac=1.0):
    cfg = VIOConfig(max_features=n)
    st = full_state(cfg)
    d = st.state_dim
    m = 2 * n
    z = st.feat_mu[:, :2] + 0.001
    mc = jnp.tile(jnp.eye(2, dtype=jnp.float32) * 1e-5, (n, 1, 1))
    k = max(1, int(round(n * measured_frac)))
    passed = jnp.arange(n) < k

    def step(s):
        return ekf.update_with_feature_positions(s, cfg, z, mc, passed)

    t = timeit_device(step, st, iters=50)
    flops = (
        4.0 * d**3          # Joseph triple product (I−KH)Σ(I−KH)ᵀ
        + m**3 / 3.0        # Cholesky of S [M,M]
        + 2.0 * m * m * d   # two triangular solves for K (M×M, D rhs)
        + 2.0 * d * m * m   # K @ R_full
        + 2.0 * d * d * m   # (K R) @ Kᵀ
    )
    bytes_ = (3 * d * d + 2 * d * m + 2 * m * m) * 4.0
    return d, roofline(flops, bytes_, t, peak_flops, peak_bw)


def bench_imu_interval(n, k_samples, peak_flops, peak_bw):
    cfg = VIOConfig(max_features=n)
    st = full_state(cfg)
    d = st.state_dim
    g = jnp.asarray([0.0, 9.81, 0.0])
    batch = imu.ImuSample(
        dt=jnp.full((k_samples,), 0.005),
        gyro=jnp.tile(jnp.asarray([0.01, -0.02, 0.03]), (k_samples, 1)),
        accel=jnp.tile(jnp.asarray([0.1, -9.7, 0.2]), (k_samples, 1)))

    def step(s):
        return imu.propagate_imu_batch(s, cfg, batch, g)

    t = timeit_device(step, st, iters=50)
    # dominated by the single Σ ← FΣFᵀ (the 29-dim chains are noise)
    flops = 4.0 * d**3
    bytes_ = 4 * d * d * 4.0
    return d, roofline(flops, bytes_, t, peak_flops, peak_bw)


def bench_klt_level(peak_flops, peak_bw):
    """The tracker ``klt.track`` dispatches to (the fused kernel on a
    GPU), full pyramid, at the reference's native 640x480, 128 features."""
    from ekf_vio_tpu.config import VIOConfig
    from ekf_vio_tpu.frontend import klt, pyramid

    h, w, n = 480, 640, 128
    cfg = VIOConfig(max_features=n)
    rng = np.random.RandomState(0)
    img0 = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
    img1 = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
    pyr0 = pyramid.build_pyramid(img0, cfg.klt_max_pyramid_level)
    pyr1 = pyramid.build_pyramid(img1, cfg.klt_max_pyramid_level)
    pts = jnp.asarray(
        rng.uniform(40, min(h, w) - 40, (n, 2)).astype(np.float32))
    valid = jnp.ones((n,), bool)

    def step(p):
        g = klt.track(pyr0, pyr1, p, p, valid, cfg).points
        # value-preserving data dependency: 0.0*g could be constant-folded
        # under fast-math, dead-code-eliminating the kernel
        return p + 1e-30 * g

    t = timeit_device(step, pts, iters=30)

    win, iters = 21, 30
    # Algorithmic FLOPs over the FULL pyramid: gradients + normal
    # equations once per level, then per iteration a bilinear window
    # sample (~8 flop/px), residual and two correlations (~5), at the
    # iteration cap (an upper bound: real features stop after a few).
    levels = 4
    alg = levels * n * (win * win) * (10 + iters * 13.0)
    bytes_ = 2 * h * w * 4.0 * (1 + 0.25 + 0.0625 + 0.015625)
    r = roofline(alg, bytes_, t, peak_flops, peak_bw)
    r["tracker_backend"] = klt.selected_backend((h, w), n, cfg)
    r["note"] = ("f32 CUDA-core arithmetic at the iteration cap against "
                 "the measured f32 matmul rate; the window taps are "
                 "gathers served from L2, so the byte count is one read "
                 "of both pyramids")
    return r


def main():
    import bench
    import ekf_vio_tpu

    ekf_vio_tpu.enable_compile_cache()
    device = bench.require_gpu()
    spec = published_peaks(device["kind"])
    peak_f32 = measure_matmul_peak_f32()
    peak_bf16 = measure_matmul_peak_bf16()
    bw = measure_hbm_bw()

    report = {
        "device": device,
        "card": bench.nvidia_smi(),
        "published_peaks": spec,
        "measured_bf16_matmul_tflops": round(peak_bf16 / 1e12, 2),
        "measured_f32_matmul_tflops": round(peak_f32 / 1e12, 2),
        "measured_hbm_bw_gbps": round(bw / 1e9, 1),
        "kernels": {},
    }
    print(json.dumps({k: v for k, v in report.items() if k != "kernels"},
                     indent=2))

    for n in (128, 256, 501):
        d, r = bench_cov_propagate(n, peak_f32, bw)
        report["kernels"][f"cov_propagate_D{d}"] = r
        print(f"cov_propagate D={d}: {json.dumps(r)}")
    for n in (128, 256, 501):
        d, r = bench_update(n, peak_f32, bw)
        report["kernels"][f"ekf_update_D{d}"] = r
        print(f"ekf_update    D={d}: {json.dumps(r)}")
    d, r = bench_imu_interval(128, 10, peak_f32, bw)
    report["kernels"][f"imu_interval10_D{d}"] = r
    print(f"imu_interval  D={d}: {json.dumps(r)}")
    r = bench_klt_level(peak_f32, bw)
    report["kernels"]["klt_full_pyramid_640x480_128feat"] = r
    print(f"klt_full_pyramid: {json.dumps(r)}")

    out = bench.out_path("speed_of_light.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
