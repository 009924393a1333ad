"""Multi-host launch scaffolding: host-aware mesh construction and the
multi-host scaling probe.

The reference is a single-process ROS node (SURVEY.md §2.2 — no
distributed anything); this is the scale-out layer.  The communication
backend is jax.distributed + XLA collectives: ``data`` (independent
sequences) is laid out across hosts, since sequences never exchange
anything, while ``state`` (Σ block partition, heavy all-gathers per
frame — parallel/sharded_filter.py) stays within one host, whose cards
are joined all to all.

The mesh construction and axis-placement logic is unit-tested on the
virtual CPU mesh (tests/test_multihost.py); benchmarks/multihost_scaling.py
is the multi-host script.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           platform: str | None = None) -> dict:
    """Bring up the jax.distributed runtime (the NCCL/MPI-equivalent
    bootstrap).  The three cluster arguments come from the caller or the
    launcher's environment; nothing detects a cluster by itself.

    Must be called before any jax computation (backend initialization
    consumes the cluster config) — so the already-initialized check reads
    ``jax._src.distributed.global_state`` instead of ``jax.process_count()``,
    which would itself initialize backends and silently turn the bootstrap
    into a no-op.

    ``platform`` (or EKF_VIO_PLATFORM) forces the JAX platform before
    backend init — "cpu" runs a real multi-process cluster on localhost
    CPU devices (gloo collectives), the configuration the 2-process CI
    test executes (tests/test_multiproc.py).
    """
    kw = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("EKF_VIO_COORDINATOR")
    if num_processes is None:
        v = os.environ.get("EKF_VIO_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("EKF_VIO_PROCESS_ID")
        process_id = int(v) if v else None
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id

    platform = platform or os.environ.get("EKF_VIO_PLATFORM")
    if platform:
        # must land before first backend use
        jax.config.update("jax_platforms", platform)

    from jax._src import distributed

    if distributed.global_state.client is None and kw:
        try:
            jax.distributed.initialize(**kw)
        except RuntimeError:
            # backends already initialized (single-process use after jax
            # calls, e.g. tests) — proceed with the local runtime
            pass

    return {
        "process_count": jax.process_count(),
        "process_index": jax.process_index(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }


def make_pod_mesh(n_state: int | None = None,
                  devices=None,
                  n_hosts: int | None = None) -> Mesh:
    """('data', 'state') mesh with host-aware axis placement.

    ``state`` (the Σ block partition with per-frame all-gathers) tiles
    devices *within* a host so its collectives stay on the host's links;
    ``data`` (independent sequences) spans hosts × the remaining local
    devices, so the only axis that crosses hosts has no per-frame traffic.

    Args:
      n_state: state-axis size (must divide the per-host device count);
        default 1 (pure data parallelism).
      devices: override device list (tests); defaults to all global devices.
      n_hosts: override host count (tests); defaults to jax.process_count().
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n_hosts = jax.process_count() if n_hosts is None else n_hosts
    n_state = 1 if n_state is None else n_state
    per_host = len(devices) // n_hosts
    if per_host * n_hosts != len(devices):
        raise ValueError(f"{len(devices)} devices not divisible by "
                         f"{n_hosts} hosts")
    if per_host % n_state != 0:
        raise ValueError(f"state axis {n_state} must divide the per-host "
                         f"device count {per_host} (host locality)")

    # devices are ordered host-major, so reshaping to
    # [hosts · per_host/n_state, n_state] keeps every state row inside one
    # host and tiles state over the fastest-varying device dimension
    arr = np.asarray(devices).reshape(n_hosts * (per_host // n_state), n_state)
    return Mesh(arr, axis_names=("data", "state"))


def host_local_batch(global_batch: int) -> int:
    """Per-process share of a ``data``-sharded batch dimension."""
    if global_batch % jax.process_count() != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{jax.process_count()} processes")
    return global_batch // jax.process_count()
