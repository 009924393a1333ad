"""Configuration for the EKF-VIO engine.

Mirrors the knob names and defaults of the reference parameter system
(reference: include/ekf_vio/Params.h:16-126, loaded at EKFVIO.cpp:20-67),
re-expressed as an immutable dataclass instead of ~50 mutable globals.

Vestigial reference knobs (MOBA/SBA/keyframe/Huber parameters that no
reference algorithm reads — see SURVEY.md §2 item 7) are intentionally
omitted; everything an algorithm actually consumes is here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    # ---- filter capacity / layout (new: fixed capacity for static XLA shapes)
    num_features: int = 100          # D_NUM_FEATURES (Params.h:46)
    max_features: int = 128          # slot capacity N_max (padded; >= num_features)

    # ---- front-end: FAST detection
    fast_threshold: int = 50         # D_FAST_THRESHOLD (Params.h:24)
    fast_blur_sigma: float = 0.0     # D_FAST_BLUR_SIGMA (Params.h:26)
    min_new_feature_dist: float = 30.0  # D_MIN_NEW_FEATURE_DIST (Params.h:43)

    # ---- front-end: KLT tracking
    klt_window_size: int = 21        # D_WINDOW_SIZE (Params.h:104)
    klt_max_pyramid_level: int = 3   # D_MAX_PYRAMID_LEVEL (Params.h:103)
    klt_iterations: int = 30         # TermCriteria COUNT (KLTTracker.cpp:63-64)
    klt_eps: float = 0.01            # TermCriteria EPS (KLTTracker.cpp:64)
    klt_min_eigen: float = 1e-4      # D_KLT_MIN_EIGEN (Params.h:36)
    kill_pad: int = 11               # D_KILL_PAD (Params.h:33)

    # ---- image handling
    inverse_image_scale: int = 4     # D_INVERSE_IMAGE_SCALE (Params.h:28)

    # ---- feature initialization
    triangulate_new_features: bool = False  # two-view depth init (the wired
    #   version of the reference's offline octave/ solvers; off = reference
    #   behavior of a constant depth prior)
    # IMU-mode depth bootstrap: young features re-initialize depth (mean +
    # variance) from two-view triangulation against the exact IMU baseline
    # once parallax appears — prevents the metric-scale transient of a
    # wrong depth prior from poisoning the velocity estimate.
    bootstrap_max_age: int = 20          # frames a feature stays eligible
    bootstrap_depth_sigma_rel: float = 0.25  # re-init σ_ρ = rel · ρ
    # Mean-quality gate for two-view depths: accept the triangulated mean
    # only when its expected relative error (σ_angle/parallax, see
    # core/depth_init.triangulate_depths) is below this — near-degenerate
    # pairs otherwise enter at wrong linearization points that poison the
    # transport Jacobians (the r3 ATE transients).  Measured on the
    # rendered benchmark: 0.5 beats 2.0 by 17% ATE (the marginal means a
    # looser gate admits carry more error than the default fallback).
    triangulation_max_rel_error: float = 0.5
    # closed-form visual-inertial alignment (core/vi_init.py)
    vi_init_frames: int = 10             # frames consumed by the initializer
    # Gauss-Newton IMU-bias refinement inside the alignment
    # (vi_init.align_with_gyro_bias): removes the zero-bias integration
    # tilt that otherwise becomes a >1° yaw transient in the filter
    vi_init_estimate_gyro_bias: bool = True
    vi_init_estimate_accel_bias: bool = True
    vi_init_gn_rounds: int = 2       # alternation rounds of the bias GN
    init_aligned_velocity_variance: float = 1e-2  # post-alignment vel var
    default_point_depth: float = 0.5           # D_DEFAULT_POINT_DEPTH (Params.h:83)
    default_point_depth_variance: float = 100.0  # D_DEFAULT_POINT_DEPTH_VARIANCE (Params.h:84)
    default_point_homogenous_variance: float = 1e-5  # (Params.h:86)

    # ---- measurement model
    klt_measurement_variance_px: float = 1e-5  # constant 2x2 R in px^2 (KLTTracker.cpp:100-106)
    # Chi-square innovation gate: a measured feature whose per-feature
    # NIS yᵀS⁻¹y (core/update.innovation_nis_per_feature) exceeds this
    # fails the frame — the standard Mahalanobis outlier rejection the
    # reference lacks entirely.  0 disables (reference behavior).  The
    # chi2_2 99.9% point is 13.8; production profiles use ~25 (beyond-5σ
    # measurements are mis-tracks: occlusions, self-similar texture,
    # specular motion — feeding them to a tight EKF integrates phantom
    # gyro-bias, measured at 0.4 rad/s on the aggressive benchmark).
    innovation_gate_chi2: float = 0.0
    # Relative structure gate: fail tracked features whose LK gradient
    # min-eigenvalue is more than this factor below the FRAME's median
    # over tracked features.  Scale-free (unlike the absolute
    # klt_min_eigen, Params.h:36, which is tied to intensity units):
    # catches degenerate image regions — grazing-angle foreshortening,
    # motion blur, defocus — where the gradient structure collapses and
    # LK slides.  Measured on the aggressive benchmark: mis-tracked
    # features carry min-eig ~100x below the frame median; rel=20 kills
    # 100% of >1 px mis-tracks while keeping the p90 error of survivors
    # at 0.06 px.  0 disables (reference behavior).
    min_eigen_rel_gate: float = 0.0
    # "constant": diagonal R from klt_measurement_variance_px — what the
    #   reference actually runs (KLTTracker.cpp:100-106).
    # "sample": the reference's written-but-never-wired SSD estimator
    #   (KLTTracker.cpp:111-175) as a live option — per-feature 2x2 R from
    #   the SSD response surface around the tracked position, floored at
    #   klt_measurement_variance_px.  Weights corner quality per feature.
    klt_covariance: str = "constant"

    # ---- process noise (per-second rates; reference hand-tuned values
    #      TightlyCoupledEKF.cpp:126-131, each multiplied by dt)
    q_pos: float = 1e-4
    q_vel: float = 0.01
    q_omega: float = 5.0
    q_accel: float = 5.0
    q_bias: float = 1e-3
    q_feature: float = 1e-4

    # ---- initial base-state variances (TightlyCoupledEKF.cpp:29-54)
    init_pose_variance: float = 0.0     # pos+quat anchored
    init_kinematic_variance: float = 30.0  # vel / omega / accel
    init_bias_variance: float = 0.5

    # ---- pipeline thresholds
    # (D_START_FEATURE_COUNT is vestigial in the reference — loaded at
    # EKFVIO.cpp:32 and read by no algorithm; D_FRAME_BUFFER_SIZE only
    # trims a ROS frame queue, EKFVIO.cpp:201, which the scan rollout has
    # no analog of.  Both intentionally omitted, like the MOBA/SBA knobs.)
    minimum_trackable_features: int = 4  # D_MINIMUM_TRACKABLE_FEATURES (Params.h:55)
    # act on tracking_lost (the reference only logs it, EKFVIO.cpp:192):
    # re-bootstrap the filter — free all slots, re-inflate kinematic
    # variances, re-detect — instead of filtering on garbage
    recover_on_tracking_lost: bool = True

    # ---- IMU fusion (new capability; reference declares USE_IMU but never
    #      fuses IMU data — EKFVIO.cpp:113-115, SURVEY.md §0)
    # use_imu selects mono-inertial mode from a profile (the CLI's --imu
    # flag is an override; configs/mono_inertial.yaml is self-sufficient)
    use_imu: bool = False            # D_USE_IMU is true but inert in reference
    # nominal IMU rate: sizes the per-camera-interval sample batch the
    # loaders emit (io/euroc.py imu_between_frames)
    imu_rate_hz: float = 200.0
    imu_gyro_noise: float = 1.7e-4   # rad/s/sqrt(Hz), EuRoC-class MEMS defaults
    imu_accel_noise: float = 2.0e-3  # m/s^2/sqrt(Hz)
    imu_gyro_bias_walk: float = 1.9e-5
    imu_accel_bias_walk: float = 3.0e-3
    gravity: float = 9.81
    # POST-ALIGNMENT bias priors (consumed only by engine.initialize_imu,
    # after vi_init's Gauss-Newton has SOLVED for the biases).  The
    # reference's 0.5 bias variance belongs to its inert random-walk bias
    # states (TightlyCoupledEKF.cpp:29-54).  These sigmas must match the
    # alignment's actual accuracy (~1-2e-3 rad/s gyro on a 0.5 s window,
    # benchmarks/consistency_diag.py): a loose prior (0.02 was round 2's
    # value) lets the filter blame early depth-transient innovations on
    # gyro bias — measured to pull the bias estimate 7x off within 1.5 s,
    # integrating a ~0.9° yaw-about-gravity error that alone tripled the
    # mono-inertial ATE (0.33% → 0.13% of path from this change).
    init_gyro_bias_sigma: float = 0.003
    init_accel_bias_sigma: float = 0.03
    # First-estimate Jacobians (consistency): evaluate the IMU-interval
    # transition Jacobians along a chain propagated from the previous
    # frame's PRIOR estimate, preserving the unobservable
    # yaw-about-gravity subspace (core/imu.py, engine.EngineState.lin_base)
    use_fej: bool = True

    # ---- numerics
    # Square-root (Cholesky-factor) predict/update (core/sqrt_filter.py):
    # every covariance op becomes an orthogonal triangularization — PSD by
    # construction, no Cholesky of S, no spectral floor needed.  ~2-3x the
    # per-step cost of the covariance form (QR vs matmul+chol); use when
    # conditioning matters more than speed (large N, long sequences).
    square_root_form: bool = False
    # Joseph-form realization in core/update.py:
    #   "expanded" — Σ − KAᵀ − AKᵀ + K S Kᵀ (rank-2M, fewer FLOPs)
    #   "product"  — (I−KH)Σ(I−KH)ᵀ + KRKᵀ  (materialized, the exact
    #   arrangement the reference commits to, TightlyCoupledEKF.cpp:586-596;
    #   guaranteed-PSD under roundoff)
    joseph_form: str = "expanded"
    sigma_jitter: float = 0.0        # optional absolute diagonal jitter on S
    # Relative spectral floor on S: λ = sigma_jitter_rel · max(diag S).
    # f32 formation of S = HΣHᵀ+R carries relative error ~ε·λmax, so
    # eigenvalues below that are noise; flooring them equals inflating R
    # (a conservative, consistency-preserving regularization).  Without it
    # an f32 blocked Cholesky can NaN at ~100 features on the first
    # update, where Σ's rank-9 kinematic block (init variance 30)
    # dominates.
    sigma_jitter_rel: float = 1e-4

    def __post_init__(self):
        # capacity bounds the target count
        if self.max_features < self.num_features:
            object.__setattr__(self, "num_features", self.max_features)
        if self.joseph_form not in ("expanded", "product"):
            raise ValueError(
                f"joseph_form must be 'expanded' or 'product', "
                f"got {self.joseph_form!r}")
        if self.klt_covariance not in ("constant", "sample"):
            raise ValueError(
                f"klt_covariance must be 'constant' or 'sample', "
                f"got {self.klt_covariance!r}")

    # state layout helpers -------------------------------------------------
    BASE_STATE_SIZE = 22  # TightlyCoupledEKF.h:11-12

    @property
    def state_dim(self) -> int:
        return self.BASE_STATE_SIZE + 3 * self.max_features

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VIOConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_yaml(cls, path: str) -> "VIOConfig":
        """Load overrides from a profile (analog of params/*.yaml).

        Profiles are flat ``key: value`` maps with ``#`` comments; each
        value is parsed as the type of the field it sets, so no YAML
        library is needed.  Unknown keys are ignored, like ``from_dict``.
        """
        fields = {f.name: f for f in dataclasses.fields(cls)}
        out = {}
        with open(path) as f:
            for lineno, raw in enumerate(f, 1):
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                key, sep, value = (t.strip() for t in line.partition(":"))
                if not sep or not key or not value:
                    raise ValueError(
                        f"{path}:{lineno}: expected 'key: value', got {raw!r}")
                if key in fields:
                    out[key] = _parse_value(fields[key].type, value,
                                            f"{path}:{lineno}")
        return cls.from_dict(out)

    def replace(self, **kw) -> "VIOConfig":
        return dataclasses.replace(self, **kw)


def _parse_value(type_name: str, value: str, where: str):
    """One profile value as the named field type ('int', 'float', 'bool'
    or 'str'; annotations are strings under postponed evaluation)."""
    if type_name == "bool":
        low = value.lower()
        if low not in ("true", "false"):
            raise ValueError(f"{where}: expected true/false, got {value!r}")
        return low == "true"
    if type_name == "str":
        return value.strip("'\"")
    try:
        return {"int": int, "float": float}[type_name](value)
    except (KeyError, ValueError) as e:
        raise ValueError(f"{where}: cannot read {value!r} as {type_name}") from e


# Base-state index map (TightlyCoupledEKF.cpp:328-393):
#   [0:3]   position (world frame)
#   [3:7]   orientation quaternion [w, x, y, z]
#   [7:10]  linear velocity (body frame)
#   [10:13] angular rate (body frame)
#   [13:16] linear acceleration (body frame)
#   [16:19] accelerometer bias
#   [19:22] gyro bias
POS = slice(0, 3)
QUAT = slice(3, 7)
VEL = slice(7, 10)
OMEGA = slice(10, 13)
ACCEL = slice(13, 16)
BIAS_ACC = slice(16, 19)
BIAS_GYRO = slice(19, 22)
BASE_STATE_SIZE = 22
