"""Faithful CPU reimplementation of the reference pipeline — the baseline.

The reference publishes no performance numbers (BASELINE.md), so this
module *establishes* the CPU baseline: the same algorithm the reference
runs, on this host's CPU, using the very same front-end calls the
reference makes (cv::calcOpticalFlowPyrLK with USE_INITIAL_FLOW and
cv::FAST — reference: KLTTracker.cpp:61-64, EKFVIO.cpp:242) and a dense
NumPy EKF with the reference's state layout, motion model, numeric
central-difference Jacobians (TightlyCoupledEKF.cpp:176-325) and
Joseph-form update (cpp:545-596).  NumPy/BLAS stands in for Eigen; both
are optimized CPU linear algebra.

This is benchmark/parity infrastructure, not part of the engine.
"""
from __future__ import annotations

import numpy as np


class CPUReferenceEKF:
    """Dense NumPy port of the reference TightlyCoupledEKF semantics."""

    BASE = 22

    def __init__(self, default_depth=0.5, depth_var=100.0, uv_var=1e-5):
        self.mu = np.zeros(self.BASE, np.float32)
        self.mu[3] = 1.0
        diag = np.concatenate([np.zeros(7), np.full(9, 30.0), np.full(6, 0.5)])
        self.Sigma = np.diag(diag).astype(np.float32)
        self.feat = np.zeros((0, 3), np.float32)  # [u, v, rho]
        self.klt_ref = np.zeros((0, 2), np.float32)
        self.default_depth = default_depth
        self.depth_var = depth_var
        self.uv_var = uv_var
        self.t = None

    # ---- motion model (convolveBaseState / convolveFeature semantics)
    @staticmethod
    def _quat_mul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ], np.float32)

    @staticmethod
    def _rot(q, v):
        w, u = q[0], q[1:]
        uv = np.cross(u, v)
        return v + 2.0 * (w * uv + np.cross(u, uv))

    @staticmethod
    def _dq(omega, dt):
        n = np.linalg.norm(omega)
        if n < 1e-10:
            q = np.array([1.0, *(omega * dt)], np.float32)
            return q / np.linalg.norm(q)
        th = dt * n
        return np.array([np.cos(th / 2), *(omega / n * np.sin(th / 2))], np.float32)

    def _convolve_base(self, mu, dt):
        out = mu.copy()
        pos, quat = mu[0:3], mu[3:7]
        vel, omega, acc = mu[7:10], mu[10:13], mu[13:16]
        out[0:3] = pos + self._rot(quat, dt * vel + 0.5 * dt * dt * acc)
        dq = self._dq(omega, dt)
        dqi = dq * np.array([1, -1, -1, -1], np.float32)
        out[3:7] = self._quat_mul(quat, dq)
        out[7:10] = self._rot(dqi, vel + dt * acc)
        out[13:16] = self._rot(dqi, acc)
        return out

    def _convolve_feats(self, mu, feat, dt):
        if len(feat) == 0:
            return feat
        vel, omega, acc = mu[7:10], mu[10:13], mu[13:16]
        z = 1.0 / feat[:, 2]
        p = np.stack([feat[:, 0] * z, feat[:, 1] * z, z], -1)
        tr = dt * vel + 0.5 * dt * dt * acc
        dqi = self._dq(omega, dt) * np.array([1, -1, -1, -1], np.float32)
        # vectorized quaternion rotation over the whole feature set
        p = p - tr
        w, u = dqi[0], dqi[1:]
        uv = np.cross(np.broadcast_to(u, p.shape), p)
        p = p + 2.0 * (w * uv + np.cross(np.broadcast_to(u, p.shape), uv))
        return np.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2], 1.0 / p[:, 2]], -1)

    # ---- numeric Jacobian (central differences, DELTA_SHIFT=1e-3).
    # Same algorithm as the reference (TightlyCoupledEKF.cpp:176-325) but
    # each perturbation evaluates the feature transport for ALL features at
    # once (the per-feature 3x3 blocks share the perturbed coordinate), so
    # the cost is O(16 + 9 + 6) vectorized model evaluations instead of
    # O(9N) scalar ones — the constant factor Eigen's compiled loops get.
    def _jacobian(self, dt):
        d = 1e-3
        n = len(self.feat)
        dim = self.BASE + 3 * n
        F = np.zeros((dim, dim), np.float32)
        F[16:22, 16:22] = np.eye(6)
        for j in range(16):
            hi, lo = self.mu.copy(), self.mu.copy()
            hi[j] += d
            lo[j] -= d
            F[: self.BASE, j] = (self._convolve_base(hi, dt)
                                 - self._convolve_base(lo, dt)) / (2 * d)
            if 7 <= j <= 15 and n:
                F[self.BASE:, j] = (
                    (self._convolve_feats(hi, self.feat, dt)
                     - self._convolve_feats(lo, self.feat, dt)) / (2 * d)
                ).reshape(-1)
        if n:
            rows = self.BASE + 3 * np.arange(n)[:, None] + np.arange(3)[None]
            for k in range(3):
                hi, lo = self.feat.copy(), self.feat.copy()
                hi[:, k] += d
                lo[:, k] -= d
                blk = (self._convolve_feats(self.mu, hi, dt)
                       - self._convolve_feats(self.mu, lo, dt)) / (2 * d)
                F[rows, (self.BASE + 3 * np.arange(n) + k)[:, None]] = blk
        return F

    def _process_noise(self, dt):
        n = len(self.feat)
        q = np.concatenate([
            np.full(7, 1e-4), np.full(3, 0.01), np.full(3, 5.0),
            np.full(3, 5.0), np.full(6, 1e-3), np.full(3 * n, 1e-4),
        ]).astype(np.float32)
        return q * dt

    def process(self, dt):
        F = self._jacobian(dt)
        self.feat = self._convolve_feats(self.mu, self.feat, dt)
        self.mu = self._convolve_base(self.mu, dt)
        self.Sigma = F @ self.Sigma @ F.T + np.diag(self._process_noise(dt))

    def add_features(self, uv):
        if len(uv) == 0:
            return
        k = len(uv)
        n0 = len(self.feat)
        new = np.concatenate(
            [uv, np.full((k, 1), 1.0 / self.default_depth, np.float32)], -1)
        self.feat = np.concatenate([self.feat, new.astype(np.float32)])
        self.klt_ref = np.concatenate([self.klt_ref, uv.astype(np.float32)])
        dim = self.BASE + 3 * (n0 + k)
        S = np.zeros((dim, dim), np.float32)
        S[: self.Sigma.shape[0], : self.Sigma.shape[1]] = self.Sigma
        pri = np.tile([self.uv_var, self.uv_var, self.depth_var], k)
        idx = np.arange(self.BASE + 3 * n0, dim)
        S[idx, idx] = pri
        self.Sigma = S

    def update(self, z, cov, passed):
        n = len(self.feat)
        meas_idx = np.flatnonzero(passed)
        if len(meas_idx) == 0:
            return
        rows = np.stack([self.BASE + 3 * meas_idx,
                         self.BASE + 3 * meas_idx + 1], -1).reshape(-1)
        mu_full = np.concatenate([self.mu, self.feat.reshape(-1)])
        y = z[meas_idx].reshape(-1) - mu_full[rows]
        A = self.Sigma[:, rows]
        S = A[rows, :].copy()
        for i, m in enumerate(meas_idx):
            S[2 * i : 2 * i + 2, 2 * i : 2 * i + 2] += cov[m]
        from scipy.linalg import cho_factor, cho_solve

        K = cho_solve(cho_factor(S), A.T).T
        mu_full = mu_full + K @ y
        dim = self.Sigma.shape[0]
        KH = np.zeros((dim, dim), np.float32)
        KH[:, rows] = K
        IKH = np.eye(dim, dtype=np.float32) - KH
        Rf = np.zeros((len(rows), len(rows)), np.float32)
        for i, m in enumerate(meas_idx):
            Rf[2 * i : 2 * i + 2, 2 * i : 2 * i + 2] = cov[m]
        self.Sigma = IKH @ self.Sigma @ IKH.T + K @ Rf @ K.T
        mu_full[3:7] /= np.linalg.norm(mu_full[3:7])
        self.mu = mu_full[: self.BASE]
        self.feat = mu_full[self.BASE:].reshape(n, 3)
        self.klt_ref[meas_idx] = z[meas_idx]

    def remove_features(self, keep_mask):
        keep_idx = np.flatnonzero(keep_mask)
        sel = np.concatenate(
            [np.arange(self.BASE)]
            + [self.BASE + 3 * i + np.arange(3) for i in keep_idx]
        ).astype(int) if len(keep_idx) else np.arange(self.BASE)
        self.Sigma = self.Sigma[np.ix_(sel, sel)]
        self.feat = self.feat[keep_idx]
        self.klt_ref = self.klt_ref[keep_idx]


class CPUReferencePipeline:
    """Per-frame pipeline: OpenCV KLT/FAST + the NumPy EKF."""

    def __init__(self, fx, fy, cx, cy, num_features=100, fast_threshold=50,
                 min_dist=30.0, kill_pad=11):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.num_features = num_features
        self.fast_threshold = fast_threshold
        self.min_dist = min_dist
        self.kill_pad = kill_pad
        self.ekf = CPUReferenceEKF()
        self.prev_img = None

    def _px(self, uv):
        return np.stack([uv[:, 0] * self.fx + self.cx,
                         uv[:, 1] * self.fy + self.cy], -1)

    def _uv(self, px):
        return np.stack([(px[:, 0] - self.cx) / self.fx,
                         (px[:, 1] - self.cy) / self.fy], -1)

    def _replenish(self, img):
        import cv2

        needed = self.num_features - len(self.ekf.feat)
        if needed <= 0:
            return
        det = cv2.FastFeatureDetector_create(
            threshold=self.fast_threshold, nonmaxSuppression=True)
        kps = det.detect(img.astype(np.uint8))
        mask = np.zeros(img.shape, np.uint8)
        if len(self.ekf.feat):
            for p in self._px(self.ekf.feat[:, :2]):
                cv2.circle(mask, (int(p[0]), int(p[1])), int(self.min_dist), 255, -1)
        new = []
        h, w = img.shape
        for kp in kps:
            if len(new) >= needed:
                break
            x, y = kp.pt
            if mask[int(y), int(x)]:
                continue
            if (x < self.kill_pad or y < self.kill_pad
                    or w - x < self.kill_pad or h - y < self.kill_pad):
                continue
            cv2.circle(mask, (int(x), int(y)), int(self.min_dist), 255, -1)
            new.append([x, y])
        if new:
            self.ekf.add_features(self._uv(np.array(new, np.float32)))

    def add_frame(self, img, t):
        import cv2

        img = img.astype(np.uint8) if img.dtype != np.uint8 else img
        if self.prev_img is None:
            self.ekf.t = t
            self._replenish(img)
            self.prev_img = img
            return
        dt = t - self.ekf.t
        self.ekf.process(dt)
        self.ekf.t = t
        if len(self.ekf.feat):
            prev_px = self._px(self.ekf.klt_ref).reshape(-1, 1, 2).astype(np.float32)
            seed_px = self._px(self.ekf.feat[:, :2]).reshape(-1, 1, 2).astype(np.float32)
            pts, st, _ = cv2.calcOpticalFlowPyrLK(
                self.prev_img, img, prev_px, seed_px.copy(),
                winSize=(21, 21), maxLevel=3,
                criteria=(cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 30, 0.01),
                flags=cv2.OPTFLOW_USE_INITIAL_FLOW, minEigThreshold=1e-4)
            pts = pts.reshape(-1, 2)
            st = st.reshape(-1).astype(bool)
            h, w = img.shape
            inb = ((pts[:, 0] >= self.kill_pad) & (pts[:, 1] >= self.kill_pad)
                   & (w - pts[:, 0] >= self.kill_pad)
                   & (h - pts[:, 1] >= self.kill_pad))
            passed = st & inb
            cov = np.tile(np.diag([1e-5 / self.fx**2, 1e-5 / self.fy**2]
                                  ).astype(np.float32), (len(pts), 1, 1))
            self.ekf.update(self._uv(pts), cov, passed)
            self.ekf.remove_features(passed)
        self._replenish(img)
        self.prev_img = img
