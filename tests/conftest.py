"""Test environment: the CPU, split into an 8-device virtual mesh.

Sharding tests run over ``--xla_force_host_platform_device_count=8``
virtual CPU devices (the standard JAX single-host multi-device
simulation).  The suite runs on the CPU unless ``JAX_PLATFORMS`` says
otherwise; tests that need a GPU carry the ``gpu`` marker and skip
without one (tests/test_gpu_hardware.py names the command that runs
them on the card).
"""
import os

# Raise the stack soft limit before jax loads: one full-suite run
# segfaulted inside XLA's CPU backend_compile (deep-graph recursion
# against the 8 MB default stack); threads created after this inherit
# the larger limit.  Harmless when the default suffices.
try:
    import resource

    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    _want = 512 * 1024 * 1024
    if _soft != resource.RLIM_INFINITY and _soft < _want:
        _new = _want if _hard == resource.RLIM_INFINITY else min(_want, _hard)
        resource.setrlimit(resource.RLIMIT_STACK, (_new, _hard))
except (ImportError, ValueError, OSError):
    pass

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# Fast/slow tiers: the full suite takes ~14 min on CPU (compile-heavy
# rollouts); `pytest -m "not slow"` is the fast tier (< 5 min).  Tests
# measured >= ~7 s (full-suite --durations run, benchmarks/test_tiers.json)
# are marked here centrally; tests can also carry @pytest.mark.slow
# directly.
# ---------------------------------------------------------------------------
_SLOW_TESTS = {
    "test_vi_init.py::test_engine_initialize_imu_end_to_end",
    "test_imu.py::TestCovariance::test_batch_scan_matches_loop",
    "test_imu.py::TestCovariance::test_padded_rows_are_noops",
    "test_sqrt_filter.py::TestParity::test_predict_parity",
    "test_sqrt_filter.py::TestParity::test_update_parity_partial_measurements",
    "test_sqrt_filter.py::TestFactorNative::test_engine_sqrt_mode_rendered",
    "test_sqrt_filter.py::TestIsolation::test_inactive_rows_stay_isolated",
    "test_sim.py::test_depth_converges_with_known_velocity",
    "test_engine.py::test_mono_inertial_rollout",
    "test_engine.py::test_triangulated_depth_init_improves_depth",
    "test_rendered.py::TestDepthDiverseScene::test_mono_inertial_two_plane",
    "test_rendered.py::test_mono_inertial_position_nees_consistent",
    "test_rendered.py::test_full_vio_imu_mode_runs",
    "test_rendered.py::test_tracking_lost_recovery_on_blanked_frames",
    "test_parallel.py::test_graft_dryrun_multichip",
    "test_parallel.py::test_sharded_step_matches_unsharded",
    "test_parallel.py::test_batched_engine_two_sequences",
    "test_parallel.py::test_graft_entry_single_chip",
    "test_sharded_filter.py::test_sharded_blackout_recovery_matches_dense",
    "test_sharded_filter.py::test_full_sharded_engine_step_parity",
    "test_distortion.py::TestDistortedChain::"
    "test_engine_on_undistorted_imagery_tracks_and_holds_ate",
    "test_multiproc.py::test_two_process_cluster_runs_sharded_filter_step",
    "test_multiproc.py::test_two_process_cluster_with_state_axis",
    "test_euroc_tree.py::TestEndToEnd::test_run_sequence_imu_from_tree",
    "test_cli.py::test_cli_run_streaming_insight",
    "test_frontend.py::TestKLT::test_zero_motion",
    "test_frontend.py::TestKLT::test_known_integer_shift",
    "test_frontend.py::TestKLT::test_min_eig_rejects_flat_region",
    "test_frontend.py::TestKLT::test_opencv_parity_on_fixture_pair",
    "test_frontend.py::TestReplenish::test_selects_separated_corners",
    "test_pallas_lk.py::TestPallasLKParity::test_vmapped_batch_matches_per_lane",
    "test_pallas_lk.py::TestPallasLKParity::test_translation_parity",
    "test_vi_init.py::TestAlign::test_recovers_v0_and_depths_exactly",
    "test_dynamics.py::TestAnalyticTransportJacobians::test_blocks_match_autodiff",
    "test_cli.py::test_cli_run_synthetic",
    "test_dynamics.py::TestCovariancePropagation::test_structured_equals_dense",
    "test_imu.py::TestJacobians::test_G_structure",
    "test_sharded_filter.py::test_sharded_predict_parity",
    "test_rendered.py::TestDepthDiverseScene::test_vision_only_two_plane",
    "test_filter.py::TestCompactedUpdate::test_compacted_matches_full_when_it_fits",
    "test_io_viz.py::TestCheckpoint::test_orbax_roundtrip",
}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        key = item.nodeid.split("tests/")[-1]
        if key in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
