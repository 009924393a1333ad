"""Device-mesh construction and sharding rules.

The reference has zero parallelism (single-threaded ROS callbacks,
SURVEY.md §2.2); every axis here is new design:

* ``data``  — batch of independent video sequences (data parallelism;
  the EuRoC multi-sequence config)
* ``state`` — block partition of the filter covariance's trailing
  dimension for large-N filters; GSPMD turns the blocked covariance
  matmuls into sharded matmuls with collectives

The communication backend is XLA collectives via ``jax.sharding`` (NCCL
on GPUs), in place of a hand-rolled NCCL/MPI layer.  The cards of one
host are joined all to all, so a mesh follows the algorithm alone.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int, n_state: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_data * n_state
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(n_data, n_state)
    return Mesh(dev, axis_names=("data", "state"))


def filter_state_shardings(mesh: Mesh, batched: bool = True):
    """NamedShardings for a (batched) FilterState pytree.

    Σ is partitioned along its *columns* over ``state`` — the predict
    (FΣFᵀ) and update (Joseph product) then run as sharded matmuls where
    each device owns a column block and GSPMD inserts the reduce/gather
    traffic on ICI.  Mean vectors and masks are small; they stay
    replicated along ``state`` and sharded along ``data`` only.
    """
    b = ("data",) if batched else ()

    def s(*spec):
        return NamedSharding(mesh, P(*b, *spec))

    from ekf_vio_tpu.core.state import FilterState

    return FilterState(
        base_mu=s(None),
        feat_mu=s(None, None),
        active=s(None),
        klt_ref=s(None, None),
        Sigma=s(None, "state"),
        t=s(),
        age=s(None),
    )


def aligned_capacity(n_features: int, n_state: int) -> int:
    """Smallest slot capacity >= n_features with state dim (22+3N)
    divisible by the ``state`` axis size (Σ blocks must tile evenly)."""
    n = n_features
    while (22 + 3 * n) % n_state != 0:
        n += 1
    return n


def replicate(mesh: Mesh, tree):
    """Fully replicate a pytree across the mesh."""
    sh = NamedSharding(mesh, P())
    return jax.device_put(tree, sh)
