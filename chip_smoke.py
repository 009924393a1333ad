"""Smoke run of the VIO pipeline on one GPU, through its public entry
points, at the benchmark's operating points.

    python chip_smoke.py              # one card: phases 0-2
    python chip_smoke.py --four-gpus  # four cards: the multi-device path

Phases (one process; every phase must pass, nothing is caught):
  0. the device: nvidia-smi's name and power limit, the JAX version,
     device kind and count; fails unless JAX's platform is ``gpu``;
  1. tracker parity at real widths: the backend ``klt.selected_backend``
     picks on the card against the plain XLA tracker (``klt.track_xla``,
     run at float32 matmul precision) on the card;
  2. the main path: (a) vision-only 640x480 ÷4, 128 slots, 240 frames
     (``engine.run_sequence``), with its first 10 frames re-run on the
     host CPU and compared; (b) mono-inertial with VI-init on the
     rendered sequence (``engine.run_sequence_imu``); (c) the
     fast_with_insight point, 400 features at 320x240, 512 slots;
     (d) 16 vmapped lanes of (a) (``run_sequences_batched``).

``--four-gpus`` runs only the multi-device path and what it is compared
with: ``run_sequences_sharded`` over a 4-card ``data`` mesh against
``run_sequences_batched`` on one card, and the state-sharded filter and
engine step at 256 slots over a 4-card ``state`` mesh against the dense
single-card step.

The frames/s printed are information for the reader, not a benchmark
result (bench.py is the benchmark).  The last line of output is the
JSON device record; it is printed only when every phase passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Tracker parity tolerances.  The fused kernel reproduces the XLA
# tracker's arithmetic (same bf16-rounded pixels, same border model, same
# per-feature stopping rule) but sums in another order, so a feature at
# the edge of a gate may flip; these are the bounds the previous fused
# tracker was held to against the same reference.
STATUS_AGREEMENT_MIN = 0.99   # share of valid features with equal status
POINT_DELTA_MAX_PX = 0.02     # on features both call tracked

# The same rollout computed two ways (GPU vs host CPU for the first 10
# frames of phase 2(a); 16 vmapped lanes vs the single run in 2(d); 4
# devices vs 1 in --four-gpus) sums in another order: the CPU runs the
# plain tracker, the GPU the kernel and cuBLAS/cuSOLVER, and batch size
# changes the matmul algorithms.  The
# kinematic states (velocity, rates, acceleration; prior variance 30) are
# barely observable in the first frames, so the filter's gain amplifies
# those f32 ulps there most: on an H100 they reached 4e-4 to 8e-4 while
# the pose stayed within 9e-5, at default and at float32 matmul
# precision alike (so TF32 is not the cause).  Bounds: pose (position +
# quaternion) 5e-4, the whole base state 3e-3 — a broken path (a wrong
# tracker, a lost feature set, a NaN) moves them by 1e-2 to metres.
# Points are held to the tracker parity bound.
POSE_DELTA_MAX = 5e-4
STATE_DELTA_MAX = 3e-3

# Operating points: phase 1 tracks (h, w, slots, vmapped lanes or 0) at
# the widths of the cells below and at full 640x480; phase 2 runs bench.py's 240-frame sequence, the
# mono-inertial run over the 40 frames the 2 cm bound was set on, and
# 16 lanes, as bench.py's batch cell; the CPU comparison covers the
# first 10 frames.  --four-gpus runs 16 lanes of 120 frames (4 per
# card) and the state-sharded step at 256 slots.
TRACKER_CASES = ((120, 160, 128, 0), (240, 320, 512, 0),
                 (480, 640, 128, 0), (120, 160, 128, 16))
N_FRAMES = 240
IMU_FRAMES = 40
LANES = 16
CPU_FRAMES = 10
FOUR_GPU_FRAMES = 120
STATE_SLOTS = 256


def say(*a):
    print(*a, flush=True)


def phase_device(expect_count=None):
    import jax

    import bench

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"FAIL phase 0: JAX's default device is {dev.platform!r}, "
                 "not a GPU")
    cards = bench.nvidia_smi().splitlines()
    for line in cards:
        say(f"phase 0: nvidia-smi: {line}")
    say(f"phase 0: jax {jax.__version__}, device_kind {dev.device_kind!r}, "
        f"{len(jax.devices())} device(s)")
    if expect_count is not None and len(jax.devices()) < expect_count:
        sys.exit(f"FAIL phase 0: need {expect_count} GPUs, "
                 f"found {len(jax.devices())}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}, cards[0]


def _tracker_scene(h, w, n, seed):
    """Textured pair (cur = prev shifted by a sub-pixel offset) and n
    feature positions on texture; 1 in 16 rows invalid (NaN positions,
    as the engine stores in dead slots)."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    shift = (1.6 + 0.1 * (seed % 4), -2.4 + 0.2 * (seed % 3))
    img2 = ndi.shift(img, shift, order=3, mode="nearest")
    q = np.stack([rng.uniform(25, w - 25, n), rng.uniform(25, h - 25, n)],
                 -1).astype(np.float32)
    valid = np.arange(n) % 16 != 5
    q[~valid] = np.nan
    return img.astype(np.float32), img2.astype(np.float32), q, valid


def _parity(name, got_pts, got_ok, ref_pts, ref_ok, valid):
    got_ok, ref_ok, valid = map(np.asarray, (got_ok, ref_ok, valid))
    agree = (got_ok == ref_ok)[valid].mean()
    both = got_ok & ref_ok
    d = np.abs(np.asarray(got_pts) - np.asarray(ref_pts))[both]
    dmax = float(d.max()) if d.size else 0.0
    say(f"  {name}: status agreement {agree:.4f} over {int(valid.sum())} "
        f"valid, tracked {int(ref_ok.sum())} (reference) / "
        f"{int(got_ok.sum())}, max |dpoint| {dmax:.2e} px")
    if agree < STATUS_AGREEMENT_MIN or dmax > POINT_DELTA_MAX_PX:
        sys.exit(f"FAIL {name}: status agreement {agree:.4f} "
                 f"(min {STATUS_AGREEMENT_MIN}), max |dpoint| {dmax} px "
                 f"(max {POINT_DELTA_MAX_PX})")
    if ref_ok.sum() < 0.8 * valid.sum():
        sys.exit(f"FAIL {name}: reference tracked only {ref_ok.sum()}")


def phase_tracker():
    """Phase 1."""
    import jax
    import jax.numpy as jnp

    import bench
    from ekf_vio_tpu.config import VIOConfig
    from ekf_vio_tpu.frontend import klt, pyramid

    say("phase 1: tracker kernel vs the plain XLA tracker")
    for h, w, n, lanes in TRACKER_CASES:
        cfg = VIOConfig(max_features=n)
        backend = klt.selected_backend((h, w), n, cfg)
        if jax.default_backend() == "gpu" and backend != "pallas_lk":
            sys.exit(f"FAIL phase 1: the GPU selects {backend!r}")
        scenes = [_tracker_scene(h, w, n, s) for s in range(max(lanes, 1))]
        prev, cur, q, valid = (jnp.asarray(np.stack(x)) for x in zip(*scenes))

        def one(fn, p, c, qq, v):
            pp = pyramid.build_pyramid(p, cfg.klt_max_pyramid_level)
            cp = pyramid.build_pyramid(c, cfg.klt_max_pyramid_level)
            r = fn(pp, cp, qq, qq, v, cfg)
            return r.points, r.status

        def runner(fn):
            f = jax.vmap(lambda *a: one(fn, *a))
            if not lanes:
                f = lambda *a: jax.tree.map(  # noqa: E731
                    lambda x: x[None], one(fn, *(x[0] for x in a)))
            return jax.jit(f)

        got_fn, ref_fn = runner(klt.track), runner(klt.track_xla)
        (got_pts, got_ok), t_got = bench.timed(
            lambda: got_fn(prev, cur, q, valid), repeats=5)
        with jax.default_matmul_precision("float32"):
            (ref_pts, ref_ok), t_ref = bench.timed(
                lambda: ref_fn(prev, cur, q, valid), repeats=5)
        name = (f"{w}x{h}, {n} slots" + (f", {lanes} vmapped lanes"
                                          if lanes else ""))
        say(f"  {name}: backend {backend}; {t_got * 1e3:.3f} ms vs "
            f"XLA {t_ref * 1e3:.3f} ms per call")
        _parity(name, got_pts, got_ok, ref_pts, ref_ok, valid)


def _fps_line(label, fps, card):
    say(f"  {label}: {fps:.1f} frames/s steady state on {card} "
        "(information, not a benchmark result)")


def _state_delta(a, b):
    """(max |d| over position + quaternion, max |d| over the base state)."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(d[..., :7].max()), float(d.max())


def _check_tracking(label, outs, floor, skip=5):
    mu = np.asarray(outs.base_mu)
    tracked = np.asarray(outs.num_tracked)
    if not np.isfinite(mu).all():
        sys.exit(f"FAIL {label}: non-finite state")
    if tracked[..., skip:].min() <= floor:
        sys.exit(f"FAIL {label}: tracking fell to {tracked[..., skip:].min()}"
                 f" (floor {floor})")
    return tracked


def phase_main_path(card):
    """Phase 2 (a)-(d)."""
    import jax
    import jax.numpy as jnp

    import bench
    from ekf_vio_tpu import engine
    from ekf_vio_tpu.core import filter as ekf
    from ekf_vio_tpu.parallel.batched_engine import run_sequences_batched

    say("phase 2: main path")
    frames, times = bench.make_frames(n_frames=N_FRAMES)
    ts = jnp.asarray(times)

    # (a) vision-only
    cfg = bench.vision_cfg()
    cam, small = bench.processing_inputs(frames, cfg)
    step = jax.jit(engine.step, static_argnums=(3, 4))
    e0 = engine.initialize(small[0], ts[0], cfg, cam)
    compiled = step.lower(e0, small[1], ts[1], cfg, cam).compile()
    say(f"  (a) engine.step memory_analysis: {compiled.memory_analysis()}")
    (estate, outs), dt = bench.timed(
        lambda: engine.run_sequence(small, ts, cfg, cam))
    tracked = _check_tracking("(a)", outs, 10)
    say(f"  (a) vision-only {small.shape[2]}x{small.shape[1]}, "
        f"{cfg.max_features} slots, {N_FRAMES} frames: tracked "
        f"min {tracked[5:].min()} mean {tracked[5:].mean():.1f}")
    _fps_line("(a)", (N_FRAMES - 1) / dt, card)

    # (a) first frames on the host CPU, compared with the card
    cpu = jax.devices("cpu")[0]
    gpu_e, gpu_o = engine.run_sequence(small[:CPU_FRAMES], ts[:CPU_FRAMES],
                                       cfg, cam)
    cpu_e, cpu_o = engine.run_sequence(
        jax.device_put(small[:CPU_FRAMES], cpu),
        jax.device_put(ts[:CPU_FRAMES], cpu), cfg, cam)
    pose_d, mu_d = _state_delta(gpu_o.base_mu, cpu_o.base_mu)
    act_g = np.asarray(gpu_e.filt.active)
    act_c = np.asarray(cpu_e.filt.active)
    both = act_g & act_c
    pts_d = float(np.abs(np.asarray(gpu_e.filt.feat_mu[:, :2])
                         - np.asarray(cpu_e.filt.feat_mu[:, :2]))[both].max()
                  ) * cam.fx
    agree = float((act_g == act_c).mean())
    say(f"  (a) first {CPU_FRAMES} frames, GPU vs host CPU: max |dpose| "
        f"{pose_d:.2e}, max |dbase_mu| {mu_d:.2e}, max |dpoint| "
        f"{pts_d:.2e} px over {int(both.sum())} features, slot agreement "
        f"{agree:.4f}, tracked {np.asarray(gpu_o.num_tracked).tolist()} vs "
        f"{np.asarray(cpu_o.num_tracked).tolist()}")
    if (pose_d > POSE_DELTA_MAX or mu_d > STATE_DELTA_MAX
            or pts_d > POINT_DELTA_MAX_PX or agree < STATUS_AGREEMENT_MIN):
        sys.exit("FAIL (a) GPU vs CPU beyond tolerance")

    # (b) mono-inertial with VI-init
    icfg = bench.imu_cfg()
    seq, icam, args = bench.imu_inputs(IMU_FRAMES)
    (_, iouts), dt = bench.timed(lambda: engine.run_sequence_imu(
        *args, icfg, icam, init_frames=icfg.vi_init_frames))
    _check_tracking("(b)", iouts, 10)
    err = float(np.linalg.norm(np.asarray(iouts.base_mu)[-1, :3]
                               - seq.gt_pos[-1]))
    say(f"  (b) mono-inertial, {IMU_FRAMES} frames with VI-init: final "
        f"position error {err * 100:.3f} cm")
    if err >= 0.02:
        sys.exit(f"FAIL (b): final position error {err} m >= 2 cm")
    _fps_line("(b)", (IMU_FRAMES - icfg.vi_init_frames) / dt, card)

    # (c) fast_with_insight
    fcfg = bench.fwi_cfg()
    fcam, fsmall = bench.processing_inputs(frames, fcfg)
    (festate, fouts), dt = bench.timed(
        lambda: engine.run_sequence(fsmall, ts, fcfg, fcam))
    ftracked = _check_tracking("(c)", fouts, 10)
    if ftracked[10:].mean() <= 250:
        sys.exit(f"FAIL (c): tracked only {ftracked[10:].mean():.0f}")
    min_diag, asym = ekf.check_sigma(festate.filt)
    sig = np.asarray(festate.filt.Sigma)
    say(f"  (c) fast_with_insight {fsmall.shape[2]}x{fsmall.shape[1]}, "
        f"{fcfg.max_features} slots: tracked mean {ftracked[10:].mean():.1f}"
        f", checkSigma min diag {float(min_diag):.2e}, asym "
        f"{float(asym):.2e}")
    if not (np.isfinite(sig).all() and float(min_diag) >= -1e-5
            and float(asym) < 1e-3):
        sys.exit("FAIL (c): checkSigma invariants")
    _fps_line("(c)", (N_FRAMES - 1) / dt, card)

    # (d) vmapped lanes of (a)
    imgs_b = jnp.broadcast_to(small, (LANES,) + small.shape)
    ts_b = jnp.broadcast_to(ts, (LANES, N_FRAMES))
    (_, bouts), dt = bench.timed(
        lambda: run_sequences_batched(imgs_b, ts_b, cfg, cam), repeats=2)
    _check_tracking("(d)", bouts, 10)
    lane_d = float(np.abs(np.asarray(bouts.base_mu)
                          - np.asarray(outs.base_mu)[None]).max())
    say(f"  (d) {LANES} vmapped lanes: max |dbase_mu| vs the single run "
        f"{lane_d:.2e}")
    if lane_d > STATE_DELTA_MAX:
        sys.exit(f"FAIL (d): lanes differ from the single run by {lane_d} "
                 f"(max {STATE_DELTA_MAX})")
    _fps_line("(d) aggregate", LANES * (N_FRAMES - 1) / dt, card)


def phase_four_gpus():
    """The multi-device path on 4 cards against one card."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    import bench
    from ekf_vio_tpu.parallel import batched_engine

    devices = jax.devices()[:4]
    n_frames, lanes = FOUR_GPU_FRAMES, LANES
    say(f"phase 4: multi-device path on {len(devices)} devices")
    frames, times = bench.make_frames(n_frames=n_frames + 4 * (lanes - 1))
    cfg = bench.vision_cfg()
    cam, small = bench.processing_inputs(frames, cfg)
    # distinct lanes: lane i starts 4 frames after lane i-1
    imgs = jnp.stack([small[4 * i: 4 * i + n_frames] for i in range(lanes)])
    ts = jnp.broadcast_to(jnp.asarray(times[:n_frames]), (lanes, n_frames))

    mesh = jax.sharding.Mesh(np.array(devices), ("data",))
    (_, s_outs), dt_s = bench.timed(lambda: batched_engine.run_sequences_sharded(
        imgs, ts, cfg, cam, mesh), repeats=2)
    # the single-device reference runs the same per-device program: its
    # lanes in micro-batches of the shard size, one after another
    one = jax.sharding.SingleDeviceSharding(devices[0])
    imgs1, ts1 = jax.device_put(imgs, one), jax.device_put(ts, one)
    per_device = lanes // len(devices)
    (_, b_outs), dt_b = bench.timed(lambda: batched_engine.run_sequences_batched(
        imgs1, ts1, cfg, cam, microbatch=per_device), repeats=2)
    _check_tracking("sharded", s_outs, 10)
    pose_d, mu_d = _state_delta(s_outs.base_mu, b_outs.base_mu)
    trk_eq = float((np.asarray(s_outs.num_tracked)
                    == np.asarray(b_outs.num_tracked)).mean())
    say(f"  run_sequences_sharded ({len(devices)} devices) vs "
        f"run_sequences_batched (1 device), {lanes} lanes x {n_frames} "
        f"frames: max |dpose| {pose_d:.2e}, max |dbase_mu| {mu_d:.2e}, "
        f"num_tracked equal on {trk_eq:.4f} of frames; "
        f"{lanes * (n_frames - 1) / dt_s:.1f} vs "
        f"{lanes * (n_frames - 1) / dt_b:.1f} aggregate frames/s "
        "(information)")
    if (pose_d > POSE_DELTA_MAX or mu_d > STATE_DELTA_MAX
            or trk_eq < STATUS_AGREEMENT_MIN):
        sys.exit("FAIL sharded vs single-device lanes beyond tolerance")

    errs = __graft_entry__.dryrun_multichip(len(devices),
                                            engine_slots=STATE_SLOTS)
    say(f"  state-sharded filter and engine step over a {len(devices)}-"
        f"device state mesh match the dense single-device step: {errs}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the multi-device path on 4 cards")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(REPO, "ekf_vio_tpu")):
        sys.exit("FAIL: the ekf_vio_tpu package is not beside this script")
    sys.path.insert(0, REPO)
    # the host CPU stays reachable for phase 2's comparison
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import ekf_vio_tpu

    ekf_vio_tpu.enable_compile_cache()
    device, card = phase_device(4 if args.four_gpus else None)
    if args.four_gpus:
        phase_four_gpus()
    else:
        phase_tracker()
        phase_main_path(card)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
