"""Batched + sharded filter execution (data parallel × state parallel).

Covers BASELINE.json configs 4 and 5: many sequences data-parallel across
chips, and large filter states with the covariance block-partitioned over
the ``state`` mesh axis.  The batch dimension is a plain ``vmap``; the
covariance partition is expressed as sharding constraints and GSPMD
compiles the blocked covariance algebra into sharded matmuls with
collectives — no hand-written communication (SURVEY.md §2.2 item 3).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.core import filter as ekf
from ekf_vio_tpu.parallel import mesh as mesh_mod


def init_batched_state(cfg: VIOConfig, batch: int, key=None):
    """A batch of freshly initialized filters with the full feature budget
    active at randomized positions (the large-state benchmark setup)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    base = ekf.init_state(cfg)

    def one(k):
        uv = jax.random.uniform(k, (cfg.max_features, 2), minval=-1.0, maxval=1.0)
        return ekf.add_features(base, cfg, uv, jnp.ones((cfg.max_features,), bool))

    return jax.vmap(one)(jax.random.split(key, batch))


def make_batched_filter_step(cfg: VIOConfig, mesh: Mesh | None = None):
    """Returns a jitted step: (batched FilterState, z, dt) -> FilterState.

    One predict + one masked update per sequence in the batch — the
    compute core of the per-frame pipeline (the image front-end is
    per-device work that shards trivially along ``data``).
    With a mesh, Σ is constrained to P('data', None, 'state').
    """

    def one_step(state, z, dt):
        state = ekf.predict(state, cfg, dt)
        meas_cov = jnp.tile(
            jnp.eye(2, dtype=state.Sigma.dtype) * 1e-5, (cfg.max_features, 1, 1)
        )
        return ekf.update_with_feature_positions(state, cfg, z, meas_cov, state.active)

    vstep = jax.vmap(one_step, in_axes=(0, 0, None))

    if mesh is None:
        return jax.jit(vstep)

    sh = mesh_mod.filter_state_shardings(mesh, batched=True)
    z_sh = NamedSharding(mesh, P("data", None, None))

    def sharded_step(state, z, dt):
        state = jax.lax.with_sharding_constraint(state, sh)
        out = vstep(state, z, dt)
        return jax.lax.with_sharding_constraint(out, sh)

    return jax.jit(
        sharded_step,
        in_shardings=(sh, z_sh, None),
        out_shardings=sh,
    )


def scaling_efficiency_probe(cfg: VIOConfig, mesh: Mesh, batch: int, steps: int = 10):
    """Time the sharded batched step; used by the multi-host scaling bench."""
    import time

    state = init_batched_state(cfg, batch)
    state = jax.device_put(state, mesh_mod.filter_state_shardings(mesh, True))
    z = state.feat_mu[:, :, :2]
    step = make_batched_filter_step(cfg, mesh)

    state = step(state, z, 0.05)  # compile
    jax.block_until_ready(state)
    t0 = time.time()
    for _ in range(steps):
        state = step(state, z, 0.05)
    jax.block_until_ready(state)
    return (time.time() - t0) / steps
